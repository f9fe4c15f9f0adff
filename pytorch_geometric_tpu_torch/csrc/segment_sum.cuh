// The receiver-sorted segment sum, shared by the sources that launch it:
// sorted_spmm.cu (the sorted GCN's aggregation) and packed_rgcn.cu (the
// receiver sums of the RGCN forward's messages).
//
//   out[r, :] = sum_{p in [row_ptr[r], row_ptr[r+1])} msgs[p, :]
//
// A group of G lanes owns one row. Each lane reads VEC elements of a
// message with one vector load (16 bytes: 4 fp32 or 8 bf16) where the
// width and the base allow it, else one element; G is the smallest power
// of two >= min(chunks, 32), chunks = ceil(F / VEC). The rows of
// consecutive groups follow each other in memory, so a warp reads one
// contiguous stretch of messages. Sums run in CSR order, one accumulator
// per element, no atomics: every output row is written by one group, so
// two launches are bitwise equal, and rows with no messages are written
// as 0 (out may come from torch.empty). msgs is fp32 or bf16; sums and out
// are fp32.
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

// Launches the segment sum of n_rows rows of F-wide messages on stream.
template <typename T>
void dispatch(const int* row_ptr, const T* msgs, float* out, int n_rows,
              int F, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  const bool aligned = reinterpret_cast<uintptr_t>(msgs) % 16 == 0;
  if (aligned && F % kVec == 0) {
    dispatch_lanes<T, kVec>(row_ptr, msgs, out, n_rows, F, stream);
  } else {
    dispatch_lanes<T, 1>(row_ptr, msgs, out, n_rows, F, stream);
  }
}

}  // namespace segment_sum
}  // namespace
