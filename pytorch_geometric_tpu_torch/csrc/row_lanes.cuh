// Device and host code shared by the kernels in which a sub-warp of L
// lanes owns one row of a sparse operator over all its heads: bsr_gat.cu
// (the block-sparse GAT), flash_gat.cu (the dense-mask GAT), packed_gat.cu
// (the packed GAT forward and backward), packed_rgcn.cu (the forward's
// message walk, a row's lanes over its bases) and spmm_csr.cu (the CSR
// SpMM, a row's lanes over its channels and edges). The lanes of a row, their
// fixed-tree reductions, a lane's V channels as one load, a head's
// channels as whole loads, the choice of the lanes and the load width,
// and the threads the card holds at once.
//
// The port's build hashes this header with every source that includes it
// (kernels/_build.py), so an edit here rebuilds each of those libraries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The lanes of one row: a sub-warp of L lanes (4, 8, 16 or 32), aligned
// in its warp. Every reduction is a fixed tree of shuffles.
template <int L>
struct Row {
  unsigned mask;
  int lane;
  __device__ __forceinline__ Row() {
    lane = threadIdx.x & (L - 1);
    mask = (0xffffffffu >> (32 - L)) << ((threadIdx.x & 31) & ~(L - 1));
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // v summed over the lanes that agree in lane % from (a power of two)
  __device__ __forceinline__ float sum_from(float v, int from) const {
    for (int o = L / 2; o >= from; o >>= 1) {
      v += __shfl_xor_sync(mask, v, o);
    }
    return v;
  }
  // v[0], ..., v[n - 1] (n <= N) and w, each summed over `groups` groups
  // of `stride` lanes (this lane in group g = lane / stride) into group
  // 0: a fixed tree in which group g adds group g + s's values at s = 1,
  // 2, 4, ..., a level at a time for all the values, so that the shuffles
  // of a level issue together; the lanes past the last group add
  // nothing. The stride need not divide L.
  template <int N>
  __device__ __forceinline__ void sum_groups(float (&v)[N], int n, float& w,
                                             int g, int stride,
                                             int groups) const {
    for (int s = 1; s < groups; s <<= 1) {
      const bool adds = (g & (2 * s - 1)) == 0 && g + s < groups;
      const int down = s * stride;
      const float ow = __shfl_down_sync(mask, w, down, L);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (k < n) {
          const float o = __shfl_down_sync(mask, v[k], down, L);
          if (adds) v[k] += o;
        }
      }
      if (adds) w += ow;
    }
  }
  // v maxed over `groups` groups of `stride` lanes (as sum_groups: group
  // g takes group g + s's value at s = 1, 2, 4, ...), then sent from
  // group 0 back to every lane, each lane getting lane lane % stride's
  __device__ __forceinline__ float max_groups(float v, int g, int stride,
                                              int groups) const {
    for (int s = 1; s < groups; s <<= 1) {
      const float o = __shfl_down_sync(mask, v, s * stride, L);
      if ((g & (2 * s - 1)) == 0 && g + s < groups) v = fmaxf(v, o);
    }
    return __shfl_sync(mask, v, lane % stride, L);
  }
  __device__ __forceinline__ float max_from(float v, int from) const {
    for (int o = L / 2; o >= from; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(mask, v, o));
    }
    return v;
  }
  // v summed over the lanes that agree in lane / width (a power of two)
  __device__ __forceinline__ float sum_below(float v, int width) const {
    for (int o = 1; o < width; o <<= 1) v += __shfl_xor_sync(mask, v, o);
    return v;
  }
  // inclusive prefix sum over the lanes
  __device__ __forceinline__ int scan(int v) const {
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
      const int u = __shfl_up_sync(mask, v, o, L);
      if (lane >= o) v += u;
    }
    return v;
  }
  __device__ __forceinline__ int bcast(int v, int src) const {
    return __shfl_sync(mask, v, src, L);
  }
  // bit t: p of lane t
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) & mask) >> ((threadIdx.x & 31) & ~(L - 1));
  }
};

// A lane's V channels at p: one float, or one float4 (16-byte aligned).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// The C (at most KC) channels of one head of a row at p, into x, V at a
// time: float4 loads where V == 4 (C a multiple of 4, the row 16-byte
// aligned); 0 past C.
template <int KC, int V>
__device__ __forceinline__ void load_head(const float* p, int C,
                                          float (&x)[KC]) {
#pragma unroll
  for (int c = 0; c < KC; c += V) {
    float t[V];
    if (c < C) {
      load_vec<V>(p + c, t);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) x[c + v] = t[v];
  }
}

// Writes the first C of x to p, V at a time (as load_head reads them).
template <int KC, int V>
__device__ __forceinline__ void store_head(float* p, int C,
                                           const float (&x)[KC]) {
#pragma unroll
  for (int c = 0; c < KC; c += V) {
    if (c < C) {
      float t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = x[c + v];
      store_vec<V>(p + c, t);
    }
  }
}

// Channels a lane holds: 4 where C is a multiple of 4 and the rows are
// 16-byte aligned (one float4 load), else 1.
inline int channels_per_lane(int C, bool aligned) {
  return C % 4 == 0 && aligned ? 4 : 1;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Threads the current card holds at once (its SMs times the threads of
// an SM), asked once per device.
inline long long wave_threads() {
  static long long cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    cached[dev] = static_cast<long long>(sms) * per_sm;
  }
  return cached[dev];
}

// Calls f(L, V) as integral constants, for L of 4, 8, 16 or 32 (anything
// else: 32) and V of 4 or 1.
template <typename Fn>
void with_row_lanes(int L, int V, Fn&& f) {
  auto pick = [&](auto lanes) {
    if (V == 4) {
      f(lanes, std::integral_constant<int, 4>{});
    } else {
      f(lanes, std::integral_constant<int, 1>{});
    }
  };
  switch (L) {
    case 4:
      pick(std::integral_constant<int, 4>{});
      break;
    case 8:
      pick(std::integral_constant<int, 8>{});
      break;
    case 16:
      pick(std::integral_constant<int, 16>{});
      break;
    default:
      pick(std::integral_constant<int, 32>{});
  }
}

}  // namespace
