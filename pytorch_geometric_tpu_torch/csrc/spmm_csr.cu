// Weighted CSR SpMM for Hopper (sm_90a):
//
//   out[r, :] = sum_{p in [row_ptr[r], row_ptr[r+1])} val[p] * x[col[p], :]
//
// Replaces the Pallas kernel pytorch_geometric_tpu/ops/spmm.py:_spmm_kernel
// (driven by _spmm_pallas_raw). That kernel turns gather and scatter into
// one-hot matrix products over (source window, destination window) tiles
// because the TPU has no fast random access; a GPU has, so one row-parallel
// kernel over a CSR takes every edge. The backward of a static-weight SpMM
// is the same kernel over the transposed CSR.
//
// What bounds it: bytes, in principle. Per call it must read col and val
// (8 B per edge), row_ptr (4 B per row), each row of x once (F * sizeof(T)
// per source row) and write out (4 B * F per row); it does 2 flops per
// edge and feature, far below the card's rate for so few bytes. At Cora's
// shapes (3072 rows, about 13.6k edges with self loops, F = 16) that is
// about 0.5 MB, about 0.15 us at 3.35 TB/s. In practice a row is a chain
// of dependent loads (row_ptr -> col -> the neighbour's row -> the store),
// each step an L2 round trip, and a call takes as long as its longest
// chain plus the launch.
//
// The first design (spmm_csr_kernel): a group of G lanes (G = 4, 8, 16 or
// 32, the smallest power of two >= min(F, 32)) owns one row and walks its
// edges one after another; every lane of the group loads the same col[e],
// then its channels of x[col[e]], so a row of deg edges is deg steps of
// the chain deep. Each lane keeps kVec accumulators, features lane,
// lane + G, ...; wider F loops over chunks of G * kVec features. It stays
// for the widths the row map below does not take (F over 32 channel
// slots, such as 33 and 300) and for bf16 x over 64 channels, and
// probes/spmm_csr_designs.py launches it at every width.
//
// The row map (spmm_csr_rows_kernel), after the packed-GAT backward's:
// - L lanes (16 or 32) own one CSR row. P, a power of two (4 to 32), is
//   the lanes that hold the F channels at V a lane: V = 4 where F is a
//   multiple of 4 and x is 16-byte aligned (8-byte for bf16), one load of
//   the lane's four channels; else 1. So R = L / P entry groups share the
//   row: lane t keeps channels (t % P) V ... and takes the edges
//   e0 + t / P, + R, ..., NB of them (NB = 16 / R, at most 4) with every
//   col and val load, and then every gather, issued together. A row of up
//   to R NB edges (16 where R >= 4: Cora's and PubMed's rows, means ~4.4
//   and ~4.6, longest 14 and 16, at F = 16, 7 and 3) is one step of the
//   chain, not deg steps.
// - L is 32 where the rows at 32 lanes fill at most one wave of the card
//   (Cora), else 16 (PubMed: half the warps, each row still one step at
//   F = 16 and 3); never below P.
// - It runs where F takes at most 32 slots of V, except bf16 x over 64
//   channels, which keeps the first design (see dispatch).
// - The entry groups' partial sums meet in a fixed tree of shuffles
//   (row_lanes.cuh: Row<L>::sum_from), so the result is deterministic;
//   the lanes of entry group 0 store the row.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, warm device us per call,
// first design -> the library, both timed in one run by
// probes/spmm_csr_designs.py (PERF.md): Cora's GCN CSR (3072 rows, 13.6k
// edges) F = 16 4.3 -> 2.2 (bound 0.15), F = 7 4.5 -> 2.0; RCM-PubMed's
// (24,576 rows, 113k edges) F = 16 7.3 -> 4.2, F = 3 5.4 -> 3.8, F = 128
// 13.2 -> 11.1 (bound 7.8); a receiver row of 501 edges (F = 16) 84.9 ->
// 14.8. An empty kernel's plain launch takes 1.1-1.5 us the same way.
//
// Both designs: no atomics; every output row is written by exactly one
// group, with sums in a fixed order, so two launches are bitwise equal.
// Rows with no edges are written as 0, so the caller may allocate out
// with torch.empty. x is fp32 or bf16; products and sums are fp32; out is
// fp32. The GCN path builds its CSRs from the real edges and the self
// loops only (the zero-weight padding edges, which all point at one
// padding node, are left out), so its rows are short.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/spmm.py); the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const T* __restrict__ x,
                float* __restrict__ out, int n_rows, int F) {
  constexpr int kRows = kThreads / G;  // rows per block
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * kRows + threadIdx.x / G;
  if (r >= n_rows) return;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  float* o = out + static_cast<size_t>(r) * F;
  for (int f0 = 0; f0 < F; f0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const float w = __ldg(val + e);
      const T* xr = x + static_cast<size_t>(__ldg(col + e)) * F + f0 + lane;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (f0 + lane + k * G < F) acc[k] += w * load_x(xr + k * G);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int f = f0 + lane + k * G;
      if (f < F) o[f] = acc[k];
    }
  }
}

template <typename T, int G>
void launch(const int* row_ptr, const int* col, const float* val, const T* x,
            float* out, int n_rows, int F, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const int blocks = (n_rows + kRows - 1) / kRows;
  spmm_csr_kernel<T, G><<<blocks, kThreads, 0, stream>>>(row_ptr, col, val, x,
                                                         out, n_rows, F);
}

// The first design at any width.
template <typename T>
void dispatch_first(const int* row_ptr, const int* col, const float* val,
                    const T* x, float* out, int n_rows, int F,
                    cudaStream_t stream) {
  if (F <= 4) {
    launch<T, 4>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (F <= 8) {
    launch<T, 8>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (F <= 16) {
    launch<T, 16>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else {
    launch<T, 32>(row_ptr, col, val, x, out, n_rows, F, stream);
  }
}

// A lane's V channels of x at p as fp32: one 16-byte load of fp32 or one
// 8-byte load of bf16 where V == 4 (bf16 widens by a shift of its bits).
template <int V>
__device__ __forceinline__ void load_x_vec(const float* p, float (&v)[V]) {
  load_vec<V>(p, v);
}

template <int V>
__device__ __forceinline__ void load_x_vec(const __nv_bfloat16* p,
                                           float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// The row map (see the head of this file): L lanes over row r, P of them
// across the channels at V a lane, R = L / P entry groups over the edges.
template <typename T, int L, int P, int V>
__global__ void __launch_bounds__(kThreads)
spmm_csr_rows_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col,
                     const float* __restrict__ val, const T* __restrict__ x,
                     float* __restrict__ out, int n_rows, int F) {
  constexpr int R = L / P;
  // edges a lane loads at once: 16 a step for the row, at most 4 a lane
  constexpr int NB = 16 / R < 1 ? 1 : (16 / R > 4 ? 4 : 16 / R);
  const Row<L> row;
  const int r = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (r >= n_rows) return;
  const int c = (row.lane % P) * V;  // this lane's first channel
  const bool mine = c < F;
  const int e0 = __ldg(row_ptr + r);
  const int e1 = __ldg(row_ptr + r + 1);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int e = e0 + row.lane / P; e < e1; e += R * NB) {
    // NB edges: their columns and weights, then every gather, together
    int nb[NB];
    float w[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int eb = e + b * R;
      nb[b] = eb < e1 ? __ldg(col + eb) : 0;
      w[b] = eb < e1 ? __ldg(val + eb) : 0.f;
    }
    float xv[NB][V];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (mine && e + b * R < e1) {
        load_x_vec<V>(x + static_cast<size_t>(nb[b]) * F + c, xv[b]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[b][v] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (e + b * R < e1) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += w[b] * xv[b][v];
      }
    }
  }
  // the entry groups' sums meet in a fixed tree
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = row.sum_from(acc[v], P);
  if (row.lane < P && mine) {
    store_vec<V>(out + static_cast<size_t>(r) * F + c, acc);
  }
}

inline bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// Lanes of a row of spmm_csr_rows_kernel: 32 where the rows at 32 lanes
// fill at most one wave of the card, else 16; never fewer than P.
int rows_lanes(int P, int n_rows) {
  if (P > 16) return 32;
  return static_cast<long long>(n_rows) * 32 <= wave_threads() ? 32 : 16;
}

// One launch of the row map at max(L, P) lanes a row.
template <typename T, int L, int P, int V>
void launch_rows(const int* row_ptr, const int* col, const float* val,
                 const T* x, float* out, int n_rows, int F,
                 cudaStream_t stream) {
  constexpr int kL = L < P ? P : L;
  constexpr int rows = kThreads / kL;
  spmm_csr_rows_kernel<T, kL, P, V>
      <<<(n_rows + rows - 1) / rows, kThreads, 0, stream>>>(
          row_ptr, col, val, x, out, n_rows, F);
}

// Where the row map takes F (at most 32 channel slots of V), launches it
// with L lanes a row (16 or 32; 0: rows_lanes) and returns true; else
// false, and the first design runs it.
template <typename T>
bool dispatch_rows(const int* row_ptr, const int* col, const float* val,
                   const T* x, float* out, int n_rows, int F, int L,
                   cudaStream_t stream) {
  const bool aligned = aligned_to(x, 4 * sizeof(T)) && aligned16(out);
  const int V = F % 4 == 0 && aligned ? 4 : 1;
  const int slots = (F + V - 1) / V;
  if (slots > 32) return false;
  int P = 4;
  while (P < slots) P *= 2;
  if (L == 0) L = rows_lanes(P, n_rows);
  with_row_lanes(P, V, [&](auto p, auto v) {
    constexpr int kP = decltype(p)::value;
    constexpr int kV = decltype(v)::value;
    if (L == 32) {
      launch_rows<T, 32, kP, kV>(row_ptr, col, val, x, out, n_rows, F,
                                 stream);
    } else {
      launch_rows<T, 16, kP, kV>(row_ptr, col, val, x, out, n_rows, F,
                                 stream);
    }
  });
  return true;
}

// The library's choice: the row map where it takes F, but not for bf16 x
// over 64 channels (P = 32 at four a lane), where it lost to the first
// design at PubMed's shapes (probes/spmm_csr_designs.py, PERF.md); the
// first design elsewhere.
template <typename T>
void dispatch(const int* row_ptr, const int* col, const float* val,
              const T* x, float* out, int n_rows, int F,
              cudaStream_t stream) {
  const bool wide_bf16 = std::is_same<T, __nv_bfloat16>::value && F > 64;
  if (wide_bf16 ||
      !dispatch_rows(row_ptr, col, val, x, out, n_rows, F, 0, stream)) {
    dispatch_first(row_ptr, col, val, x, out, n_rows, F, stream);
  }
}

// Calls fn(x) with x typed by x_is_bf16: const __nv_bfloat16* or float*.
template <typename Fn>
void with_x_type(void* x, int x_is_bf16, Fn&& fn) {
  if (x_is_bf16) {
    fn(static_cast<const __nv_bfloat16*>(x));
  } else {
    fn(static_cast<const float*>(x));
  }
}

}  // namespace

// The row map where it takes F, else the first design.
extern "C" int spmm_csr(void* row_ptr, void* col, void* val, void* x,
                        void* out, int n_rows, int F, int x_is_bf16,
                        void* stream) {
  if (n_rows > 0 && F > 0) {
    with_x_type(x, x_is_bf16, [&](auto xt) {
      dispatch(static_cast<const int*>(row_ptr), static_cast<const int*>(col),
               static_cast<const float*>(val), xt, static_cast<float*>(out),
               n_rows, F, static_cast<cudaStream_t>(stream));
    });
  }
  return static_cast<int>(cudaGetLastError());
}
