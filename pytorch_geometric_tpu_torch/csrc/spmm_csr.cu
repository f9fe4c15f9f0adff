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
// chain plus the launch. At wide rows (F = 1433, SGC's and Spline's
// propagation of Cora's features) the x rows, 17.6 MB, stay in the 50 MB
// L2, but every edge gathers a whole row from it (78 MB at Cora's GCN
// CSR), so the gathers' L2 traffic, not device memory, sets the time.
//
// The first design (spmm_csr_kernel): a group of G lanes (G = 4, 8, 16 or
// 32, the smallest power of two >= min(F, 32)) owns one row and walks its
// edges one after another; every lane of the group loads the same col[e],
// then its channels of x[col[e]], so a row of deg edges is deg steps of
// the chain deep. Each lane keeps kVec accumulators, features lane,
// lane + G, ...; wider F loops over chunks of G * kVec features, walking
// the row again for each. It stays for bf16 x of 65 to 128 channels, and
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
//   channels (see dispatch).
// - The row walk is row_lanes.cuh's sum_row, which the fused GCN's walks
//   (fused_gcn.cu) share: the entry groups' partial sums meet in a fixed
//   tree of shuffles (Row<L>::sum_from), so the result is deterministic;
//   the lanes of entry group 0 store the row.
//
// The chunk map (spmm_csr_chunks_kernel), past 32 slots of V:
// - A warp owns W = 32 V K consecutive channels of one row, and a row is
//   ceil(F / W) warps side by side: at F = 1433 (V = 1, K = 8) 6 warps a
//   row, 18.4k on Cora, where the first design had 3072 warps, each
//   walking its row 12 times. Lane t keeps channels (k 32 + t) V + v, so
//   each gather of a warp reads 32 V consecutive channels (128 bytes of
//   fp32 at V = 1) even where F is odd and the rows of x are unaligned.
// - The row's columns and weights are loaded one an edge a lane, 32 at a
//   time, and handed round by shuffles; each lane then issues the
//   gathers of NB edges together (NB V K = 8 channels a lane; one edge
//   where V K is 8 or more) and adds their products in CSR order. The
//   warps an SM holds decide more than the loads a lane has in flight:
//   at Cora's F = 1433 and K = 8, 32 channels a lane in flight took 39.9
//   us, 16 took 18.3 and 8 took 15.9 (probes/chunk_map_variants.py,
//   PERF.md).
// - Each output element is summed over e0..e1 in CSR order in one fp32
//   accumulator, as in the first design, so the chunk map's output is
//   bitwise equal to the first design's.
// - K from the design probe (chunk_k): 1 at V = 4, 2 at V = 1 up to 64
//   channels, else 8.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, warm device us per call,
// first design -> the library, both timed in one run by
// probes/spmm_csr_designs.py (PERF.md): Cora's GCN CSR (3072 rows, 13.6k
// edges) F = 16 4.3 -> 2.2 (bound 0.15), F = 7 4.5 -> 2.0; RCM-PubMed's
// (24,576 rows, 113k edges) F = 16 7.3 -> 4.2, F = 3 5.4 -> 3.8, F = 128
// 13.2 -> 11.1 (bound 7.8); a receiver row of 501 edges (F = 16) 84.9 ->
// 14.8. The chunk map: Cora F = 1433 55.5 -> 16.0 (bound 10.5, cuSPARSE
// 62.9), bf16 x 29.4 -> 12.8; a kernel-index CSR of Spline's F = 1433
// 53.2 -> 13.3 (cuSPARSE 49.8); Cora F = 300 12.7 -> 5.7, F = 33 4.4 ->
// 4.1. An empty kernel's plain launch takes 1.1-1.5 us the same way.
//
// Every design: no atomics; every output element is written by exactly
// one lane, with sums in a fixed order, so two launches are bitwise equal.
// The launch depends on the shapes and the bases' alignment only and
// allocates nothing, so it captures in a CUDA graph.
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
  float acc[V];
  sum_row<L, V, NB>(
      row, col, val, __ldg(row_ptr + r), __ldg(row_ptr + r + 1), P, NB, mine,
      [&](int j, float(&xv)[V]) {
        load_x_vec<V>(x + static_cast<size_t>(j) * F + c, xv);
      },
      acc);
  if (row.lane < P && mine) {
    store_vec<V>(out + static_cast<size_t>(r) * F + c, acc);
  }
}

inline bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// V of x and out at F: 4 where F is a multiple of 4, x holds four
// elements aligned (16 bytes of fp32, 8 of bf16) and out is 16-byte
// aligned, else 1.
template <typename T>
int vec_of(const T* x, const float* out, int F) {
  return F % 4 == 0 && aligned_to(x, 4 * sizeof(T)) && aligned16(out) ? 4
                                                                      : 1;
}

// Lanes of a row of spmm_csr_rows_kernel: 32 where the rows at 32 lanes
// fill at most one wave of the card, else 16; never fewer than P.
int rows_lanes(int P, int n_rows) {
  if (P > 16) return 32;
  return static_cast<long long>(n_rows) * 32 <= wave_threads() ? 32 : 16;
}

// Loads a lane an edge of the chunk map in the library, on the design
// probe's times (probes/spmm_csr_designs.py, PERF.md): at V = 4 one (a
// warp owns 128 channels); at V = 1 two up to 64 channels (one chunk a
// row), else eight (256 channels a warp, two edges in flight).
inline int chunk_k(int V, int F) { return V == 4 ? 1 : (F <= 64 ? 2 : 8); }

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
  const int V = vec_of(x, out, F);
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

// The chunk map (see the head of this file): warp w owns W = 32 V K
// consecutive channels of row w / n_chunks, from c0 = (w % n_chunks) W;
// lane t keeps channels c0 + (k 32 + t) V + v, k < K, v < V. The row's
// columns and weights are loaded one an edge a lane, 32 edges at a time,
// and handed round by shuffles; a lane issues the gathers of NB edges
// together, NB V K = 8 channels (one edge where V K is 8 or more).
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
spmm_csr_chunks_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col,
                       const float* __restrict__ val, const T* __restrict__ x,
                       float* __restrict__ out, int n_rows, int F,
                       int n_chunks) {
  constexpr int W = 32 * V * K;  // channels a warp
  constexpr int NB = V * K < 8 ? 8 / (V * K) : 1;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const int r = static_cast<int>(warp / n_chunks);
  if (r >= n_rows) return;  // the whole warp: r is the warp's
  const int c0 = static_cast<int>(warp - static_cast<long long>(r) * n_chunks)
                 * W + lane * V;
  const int e0 = __ldg(row_ptr + r);
  const int e1 = __ldg(row_ptr + r + 1);
  float acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
  }
  for (int e = e0; e < e1; e += 32) {
    const int n = e1 - e < 32 ? e1 - e : 32;
    const int my_col = lane < n ? __ldg(col + e + lane) : 0;
    const float my_w = lane < n ? __ldg(val + e + lane) : 0.f;
    for (int b0 = 0; b0 < n; b0 += NB) {
      // the gathers of up to NB edges, issued together
      float w[NB];
      float xv[NB][K][V];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int src = __shfl_sync(0xffffffffu, my_col, (b0 + b) & 31);
        w[b] = __shfl_sync(0xffffffffu, my_w, (b0 + b) & 31);
        const T* xr = x + static_cast<size_t>(src) * F;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = c0 + k * 32 * V;
          if (b0 + b < n && c < F) {
            load_x_vec<V>(xr + c, xv[b][k]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) xv[b][k][v] = 0.f;
          }
        }
      }
      // then the products, in CSR order
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b0 + b < n) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[k][v] += w[b] * xv[b][k][v];
          }
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(r) * F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k * 32 * V;
    if (c < F) store_vec<V>(o + c, acc[k]);
  }
}

// One launch of the chunk map: n_rows ceil(F / W) warps, a row's side by
// side.
template <typename T, int V, int K>
void launch_chunks(const int* row_ptr, const int* col, const float* val,
                   const T* x, float* out, int n_rows, int F,
                   cudaStream_t stream) {
  constexpr int W = 32 * V * K;
  const int n_chunks = (F + W - 1) / W;
  const long long threads = static_cast<long long>(n_rows) * n_chunks * 32;
  spmm_csr_chunks_kernel<T, V, K>
      <<<static_cast<int>((threads + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(row_ptr, col, val, x, out, n_rows, F, n_chunks);
}

// The chunk map at any width, K loads a lane an edge (1, 2, 4, 8 or 16;
// at most 16 channels a lane, so K is cut to 16 / V); K = 0: the
// library's K, chunk_k.
template <typename T>
void dispatch_chunks(const int* row_ptr, const int* col, const float* val,
                     const T* x, float* out, int n_rows, int F, int K,
                     cudaStream_t stream) {
  const int V = vec_of(x, out, F);
  if (K == 0) K = chunk_k(V, F);
  if (V == 4) {
    if (K >= 4) {
      launch_chunks<T, 4, 4>(row_ptr, col, val, x, out, n_rows, F, stream);
    } else if (K == 2) {
      launch_chunks<T, 4, 2>(row_ptr, col, val, x, out, n_rows, F, stream);
    } else {
      launch_chunks<T, 4, 1>(row_ptr, col, val, x, out, n_rows, F, stream);
    }
  } else if (K >= 16) {
    launch_chunks<T, 1, 16>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (K >= 8) {
    launch_chunks<T, 1, 8>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (K >= 4) {
    launch_chunks<T, 1, 4>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (K == 2) {
    launch_chunks<T, 1, 2>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else {
    launch_chunks<T, 1, 1>(row_ptr, col, val, x, out, n_rows, F, stream);
  }
}

// The library's choice, on the design probe's times
// (probes/spmm_csr_designs.py, PERF.md): the row map where it takes F
// (at most 32 slots of V), the chunk map past it; but the first design
// for bf16 x of 65 to 128 channels, where the row map and the chunk map
// lost to it at PubMed's F = 128.
template <typename T>
void dispatch(const int* row_ptr, const int* col, const float* val,
              const T* x, float* out, int n_rows, int F,
              cudaStream_t stream) {
  const bool wide_bf16 =
      std::is_same<T, __nv_bfloat16>::value && F > 64 && F <= 128;
  if (wide_bf16) {
    dispatch_first(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (!dispatch_rows(row_ptr, col, val, x, out, n_rows, F, 0,
                            stream)) {
    dispatch_chunks(row_ptr, col, val, x, out, n_rows, F, 0, stream);
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

// The row map, the chunk map or the first design, by F (see dispatch).
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
