// The receiver-sorted segment sum, shared by the sources that launch it:
// sorted_spmm.cu (the sorted GCN's aggregation, AGNN's and DNA's sums and
// their gathers' gradients) and packed_rgcn.cu (the receiver sums of the
// RGCN forward's messages).
//
//   out[r, :] = sum_{p in [row_ptr[r], row_ptr[r+1])} msgs[p, :]
//
// Each lane reads VEC elements of a message with one vector load (16
// bytes: 4 fp32 or 8 bf16) where the width and both bases allow it, else
// one element; chunks = ceil(F / VEC) such loads cover a message. Two
// designs, chosen by width (dispatch):
//
// - The first design (sorted_segment_sum_kernel), for rows of at most one
//   warp's worth of chunks: a group of G lanes owns one row, G the
//   smallest power of two >= min(chunks, 32). The rows of consecutive
//   groups follow each other in memory, so a warp reads one contiguous
//   stretch of messages. Past 32 chunks (F over 128 fp32 channels) each
//   lane walks the row's edges again for each of its chunks, one after
//   another, and a call has one warp a row: at DNA's F = 1024 on Cora,
//   3072 warps, a third of one wave of the card.
// - The chunk map (segment_sum_chunks_kernel), for wider rows: one warp
//   owns 32 VEC K consecutive channels of one row (K loads a lane an
//   edge), so a row of F channels is ceil(F / (32 VEC K)) warps, side by
//   side in one block where they fit (at F = 1024 fp32, K = 1: a block of
//   8 warps is one row). Each lane issues the loads of kEdges = 8 edges
//   together, then adds them in CSR order.
//
// Both sum each element over e0..e1 in CSR order in one fp32 accumulator,
// so the chunk map's output is bitwise equal to the first design's. No
// atomics: every output element is written by one lane, so two launches
// are bitwise equal, and rows with no messages are written as 0 (out may
// come from torch.empty). msgs is fp32 or bf16; sums and out are fp32.
// The launch depends on the shapes and the bases' alignment only, and
// allocates nothing, so it captures in a CUDA graph.
//
// The port's build hashes this header with every source that includes it
// (kernels/_build.py), so an edit here rebuilds both libraries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace segment_sum {

constexpr int kThreads = 256;

// VEC consecutive elements of p as floats: one 16-byte load where VEC
// spans 16 bytes, else VEC scalar loads.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Loader<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const int* __restrict__ row_ptr,
                          const T* __restrict__ msgs,
                          float* __restrict__ out, int n_rows, int F) {
  constexpr int kRows = kThreads / G;  // rows per block
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * kRows + threadIdx.x / G;
  if (r >= n_rows) return;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  const int chunks = (F + VEC - 1) / VEC;  // VEC > 1 only when VEC | F
  float* o = out + static_cast<size_t>(r) * F;
  for (int c = lane; c < chunks; c += G) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const T* m = msgs + static_cast<size_t>(e0) * F + c * VEC;
#pragma unroll 4
    for (int e = e0; e < e1; ++e, m += F) {
      float v[VEC];
      Loader<T, VEC>::load(m, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[c * VEC + k] = acc[k];
  }
}

template <typename T, int VEC, int G>
void launch(const int* row_ptr, const T* msgs, float* out, int n_rows, int F,
            cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const int blocks = (n_rows + kRows - 1) / kRows;
  sorted_segment_sum_kernel<T, VEC, G>
      <<<blocks, kThreads, 0, stream>>>(row_ptr, msgs, out, n_rows, F);
}

template <typename T, int VEC>
void dispatch_lanes(const int* row_ptr, const T* msgs, float* out, int n_rows,
                    int F, cudaStream_t stream) {
  const int chunks = (F + VEC - 1) / VEC;
  if (chunks <= 4) {
    launch<T, VEC, 4>(row_ptr, msgs, out, n_rows, F, stream);
  } else if (chunks <= 8) {
    launch<T, VEC, 8>(row_ptr, msgs, out, n_rows, F, stream);
  } else if (chunks <= 16) {
    launch<T, VEC, 16>(row_ptr, msgs, out, n_rows, F, stream);
  } else {
    launch<T, VEC, 32>(row_ptr, msgs, out, n_rows, F, stream);
  }
}

// Edges whose loads a lane of the chunk map issues together.
constexpr int kEdges = 8;

// The chunk map (see the head of this file): warp w owns channels
// c0 = (w % n_chunks) 32 VEC K ... of row w / n_chunks; lane t keeps
// channels c0 + (k 32 + t) VEC + v, k < K, v < VEC.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
segment_sum_chunks_kernel(const int* __restrict__ row_ptr,
                          const T* __restrict__ msgs,
                          float* __restrict__ out, int n_rows, int F,
                          int n_chunks) {
  constexpr int W = 32 * VEC * K;  // channels a warp
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const int r = static_cast<int>(warp / n_chunks);
  if (r >= n_rows) return;
  const int c0 = static_cast<int>(warp - static_cast<long long>(r) * n_chunks)
                 * W + lane * VEC;
  const int e0 = __ldg(row_ptr + r);
  const int e1 = __ldg(row_ptr + r + 1);
  float acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;
  }
  for (int e = e0; e < e1; e += kEdges) {
    // the loads of up to kEdges messages, issued together
    float m[kEdges][K][VEC];
#pragma unroll
    for (int b = 0; b < kEdges; ++b) {
      const T* row = msgs + static_cast<size_t>(e + b) * F;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = c0 + k * 32 * VEC;
        if (e + b < e1 && c < F) {
          Loader<T, VEC>::load(row + c, m[b][k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) m[b][k][v] = 0.f;
        }
      }
    }
    // then the adds, in CSR order
#pragma unroll
    for (int b = 0; b < kEdges; ++b) {
      if (e + b < e1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[k][v] += m[b][k][v];
        }
      }
    }
  }
  float* o = out + static_cast<size_t>(r) * F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k * 32 * VEC;
    if (c < F) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int v = 0; v < VEC; v += 4) {
          *reinterpret_cast<float4*>(o + c + v) = make_float4(
              acc[k][v], acc[k][v + 1], acc[k][v + 2], acc[k][v + 3]);
        }
      } else {
        o[c] = acc[k][0];
      }
    }
  }
}

template <typename T, int VEC, int K>
void launch_chunks(const int* row_ptr, const T* msgs, float* out, int n_rows,
                   int F, cudaStream_t stream) {
  constexpr int W = 32 * VEC * K;
  const int n_chunks = (F + W - 1) / W;
  const long long threads = static_cast<long long>(n_rows) * n_chunks * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  segment_sum_chunks_kernel<T, VEC, K><<<blocks, kThreads, 0, stream>>>(
      row_ptr, msgs, out, n_rows, F, n_chunks);
}

// The chunk map at K loads a lane an edge (1, 2 or 4; at most 8 elements
// a lane an edge, so K is cut to 8 / VEC).
template <typename T, int VEC>
void dispatch_chunks(const int* row_ptr, const T* msgs, float* out,
                     int n_rows, int F, int K, cudaStream_t stream) {
  if constexpr (VEC == 1) {
    if (K >= 4) {
      launch_chunks<T, VEC, 4>(row_ptr, msgs, out, n_rows, F, stream);
      return;
    }
  }
  if constexpr (VEC <= 4) {
    if (K >= 2) {
      launch_chunks<T, VEC, 2>(row_ptr, msgs, out, n_rows, F, stream);
      return;
    }
  }
  launch_chunks<T, VEC, 1>(row_ptr, msgs, out, n_rows, F, stream);
}

// Elements a lane loads at once: one 16-byte load where F is a multiple
// of it and msgs and out are 16-byte aligned (then every row is), else 1.
template <typename T>
int vec_of(const T* msgs, const float* out, int F) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned && F % kVec == 0 ? kVec : 1;
}

// The library's design for F at vec elements a load, on the design
// probe's times (probes/segment_sum_designs.py, PERF.md): 0, the first
// design, up to 32 chunks a row; past them the chunk map at one load a
// lane an edge (returned: K = 1).
inline int chunks_k(int F, int vec) {
  return (F + vec - 1) / vec <= 32 ? 0 : 1;
}

// Launches one design of the segment sum: design 0 is the first at any
// width, K > 0 the chunk map at K loads a lane an edge.
template <typename T>
void launch_design(const int* row_ptr, const T* msgs, float* out, int n_rows,
                   int F, int design, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec_of(msgs, out, F) == kVec) {
    if (design == 0) {
      dispatch_lanes<T, kVec>(row_ptr, msgs, out, n_rows, F, stream);
    } else {
      dispatch_chunks<T, kVec>(row_ptr, msgs, out, n_rows, F, design,
                               stream);
    }
  } else if (design == 0) {
    dispatch_lanes<T, 1>(row_ptr, msgs, out, n_rows, F, stream);
  } else {
    dispatch_chunks<T, 1>(row_ptr, msgs, out, n_rows, F, design, stream);
  }
}

// Launches the segment sum of n_rows rows of F-wide messages on stream:
// the first design up to 32 chunks a row, the chunk map past them.
template <typename T>
void dispatch(const int* row_ptr, const T* msgs, float* out, int n_rows,
              int F, cudaStream_t stream) {
  launch_design(row_ptr, msgs, out, n_rows, F,
                chunks_k(F, vec_of(msgs, out, F)), stream);
}

}  // namespace segment_sum
}  // namespace
