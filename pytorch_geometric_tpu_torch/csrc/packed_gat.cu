// Fused GAT layer for Hopper (sm_90a): attention logits, per-receiver
// softmax shift, exp, hashed attention dropout and the num|den
// accumulator in one pass over CSR rows, and its backward.
//
// Replaces the Pallas kernels pytorch_geometric_tpu/ops/packed_gat.py:
// _fwd_kernel (forward) and _bwd_kernel (backward, on its side='dst' and
// side='src' packs). Those turn every gather and scatter into one-hot
// matrix products over (sender window, receiver window) tiles, because
// the TPU has no fast random access; here one row-parallel kernel walks a
// CSR and reads each neighbour's row directly.
//
// Function (per head hd, edge e = (src -> dst) with edge id eid):
//   zpre = s[src] + d[dst];  z = leaky(zpre)
//   shift = leaky(m + d[dst])           m = max over all rows of s
//   ex = exp(z - shift);  ks = keep(seed, eid, hd) ? scale : 0
//   forward:  num[dst] += ex * ks * h[src];  den[dst] += ex
//   backward (g = d loss / d num|den):
//     dot = <gnum[dst], h[src]>  over the head's C channels
//     dz  = ex * (ks * dot + gden[dst]) * (zpre > 0 ? 1 : slope)
//     dd[dst] += dz;  ds[src] += dz;  dh[src] += gnum[dst] * ex * ks
// keep() is the stateless hash of ops/packed_gat.py:_edge_keep_bits, so
// the forward and both backward passes regenerate the same dropout bits
// from the original edge id, whatever the CSR order.
//
// What bounds it: bytes. A call reads the CSR (4 B per edge and row, and
// 4 B per edge of edge ids on the sender side), s and d (4 B * H per
// node), h (4 B * H * C per node) and, backward, g (4 B * (H*C + H) per
// node); it writes 4 B * (H*C + H) per node. It does about 2 flops per
// edge and channel forward (4 backward), far below the card's rate for
// so few bytes. At Cora's conv1 shapes (3072 rows, about 13.6k edges,
// H = 8, C = 8) that is about 2 MB, under a microsecond at 3.35 TB/s, so
// a call there is bound by launch latency. On an H100 at 700 W
// (chip_smoke.py; PERF.md) the forward takes 7.6 us at Cora and 29 us at
// PubMed's shapes (bound 4.6 us); the backward, two launches, 25 and
// 110 us (bound 7 us).
// The design below is the simple one: every edge's scalars are computed
// by each lane of its group, and the two backward walks each read the
// edge's terms again.
//
// Design:
// - A group of G lanes (G = 4, 8, 16 or 32: with_group_width) owns one
//   (row, head) pair; lane l keeps the channels l, l + G, ... of a chunk
//   of G * kVec channels. Heads are independent in GAT, so a group never
//   talks to another one, and the narrow widths of the main path (C = 8
//   and 7) keep most lanes busy.
// - Every lane of a group computes the same per-edge scalars (logit,
//   exp, keep bit) with the same instructions, so they agree bitwise and
//   no broadcast is needed. The per-head dot <gnum, h> of the backward is
//   a butterfly of shuffles within the group, which leaves the same sum
//   in every lane.
// - No atomics. Forward and the receiver side of the backward walk the
//   receiver-major CSR (edge id = CSR position) and write dd; the sender
//   side walks the sender-major CSR (edge id from its permutation) and
//   writes ds and dh. Each output element is written once by one lane,
//   with sums in CSR order: the result is deterministic, and rows with no
//   edges are written as 0, so outputs may come from torch.empty.
// - m (the shift's per-head maximum) and the dropout seed are read from
//   device memory, so the caller never waits on the card for them.
// - fp32 throughout; expf (not __expf) and no fast-math flags, so the
//   kernel holds 1e-5 against the plain PyTorch version.
//
// Ablation hooks: the backward kernel takes a bit mask kAblate of terms
// to remove (namespace gat_ablate) and a run-time flag `sink`. The
// library instantiates kAblate = 0 only; probes/packed_gat_ablate.cu
// includes this file and instantiates the others, so a probe times the
// kernel that ships. A removed load is replaced by a value loaded once per
// row, and a removed store is kept behind `if (sink)` (sink = 0 at run
// time), so that nvcc cannot delete the work that feeds it.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/packed_gat.py); each launch goes on
// the caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

// Terms of the backward that an ablation removes, one bit each.
namespace gat_ablate {
constexpr unsigned kNoIndex = 1u << 0;    // other = r: no load of col[e]
constexpr unsigned kNoGatherS = 1u << 1;  // the neighbour's s or d: own
constexpr unsigned kNoGatherG = 1u << 2;  // gnum, gden: loaded once per row
constexpr unsigned kNoGatherH = 1u << 3;  // h[send] of the dot: once per row
constexpr unsigned kNoExp = 1u << 4;      // no expf
constexpr unsigned kNoDrop = 1u << 5;     // no dropout hash
constexpr unsigned kNoShuffle = 1u << 6;  // no group_sum butterfly
constexpr unsigned kNoStore = 1u << 7;    // dh and out_h stored only if sink
}  // namespace gat_ablate

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

// ops/packed_gat.py:_edge_keep_bits, in uint32 arithmetic.
__device__ __forceinline__ uint32_t edge_keep_bits(uint32_t seed, uint32_t eid,
                                                   uint32_t hd) {
  uint32_t x = (eid * 0x9E3779B1u) ^ (seed * 0xC2B2AE3Du + hd * 0x27D4EB2Fu);
  x = (x ^ (x >> 15)) * 0x2C1B3C6Du;
  x = (x ^ (x >> 12)) * 0x297A2D39u;
  return x ^ (x >> 15);
}

// keep * scale of one (edge, head): scale or 0. With thresh == 0 every
// bit pattern is kept, so the hash is skipped.
__device__ __forceinline__ float keep_scale(uint32_t seed, int eid, int hd,
                                            uint32_t thresh, float scale) {
  if (thresh == 0u) return scale;
  return edge_keep_bits(seed, static_cast<uint32_t>(eid),
                        static_cast<uint32_t>(hd)) >= thresh
             ? scale
             : 0.f;
}

// Lanes of this thread's group within its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    const int base = (threadIdx.x & 31) & ~(G - 1);
    return ((1u << G) - 1u) << base;
  }
}

template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Forward: rows of the receiver-major CSR; out is (n_rows, H*C + H),
// num in the first H*C columns, den in the last H.
template <int G>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const float* __restrict__ d, const float* __restrict__ s,
               const float* __restrict__ h, const float* __restrict__ m,
               const int* __restrict__ seed_ptr, float* __restrict__ out,
               int n_rows, int H, int C, uint32_t thresh, float scale,
               float slope) {
  const long long grp =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (grp >= static_cast<long long>(n_rows) * H) return;
  const int r = static_cast<int>(grp / H);
  const int hd = static_cast<int>(grp % H);
  const int lane = threadIdx.x % G;
  const int HC = H * C;
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const float dr = __ldg(d + static_cast<size_t>(r) * H + hd);
  const float shift = leaky(__ldg(m + hd) + dr, slope);
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  float* o = out + static_cast<size_t>(r) * (HC + H);
  for (int c0 = 0; c0 < C; c0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    float den = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int src = __ldg(col + e);
      const float z =
          leaky(__ldg(s + static_cast<size_t>(src) * H + hd) + dr, slope);
      const float ex = expf(z - shift);
      den += ex;
      const float w = ex * keep_scale(seed, e, hd, thresh, scale);
      const float* hr =
          h + static_cast<size_t>(src) * HC + hd * C + c0 + lane;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (c0 + lane + k * G < C) acc[k] += w * __ldg(hr + k * G);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = c0 + lane + k * G;
      if (c < C) o[hd * C + c] = acc[k];
    }
    if (c0 == 0 && lane == 0) o[HC + hd] = den;
  }
}

// Backward over one CSR.
//   kSrc = false: rows are receivers (receiver-major CSR, edge id = CSR
//                 position); writes dd (n_rows, H) into out_h.
//   kSrc = true:  rows are senders (sender-major CSR, edge id = eid[p]);
//                 writes ds (n_rows, H) into out_h and dh (n_rows, H*C).
// g is (n_rows, H*C + H): gnum, then gden. kAblate and sink: see the
// header (0 and 0 in the library).
template <int G, bool kSrc, unsigned kAblate = 0>
__global__ void __launch_bounds__(kThreads)
gat_bwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const int* __restrict__ eid, const float* __restrict__ d,
               const float* __restrict__ s, const float* __restrict__ h,
               const float* __restrict__ m, const float* __restrict__ g,
               const int* __restrict__ seed_ptr, float* __restrict__ out_h,
               float* __restrict__ dh, int n_rows, int H, int C,
               uint32_t thresh, float scale, float slope, int sink) {
  using namespace gat_ablate;
  constexpr bool kIndex = !(kAblate & kNoIndex);
  constexpr bool kGatherS = !(kAblate & kNoGatherS);
  constexpr bool kGatherG = !(kAblate & kNoGatherG);
  constexpr bool kGatherH = !(kAblate & kNoGatherH);
  const long long grp =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (grp >= static_cast<long long>(n_rows) * H) return;
  const int r = static_cast<int>(grp / H);
  const int hd = static_cast<int>(grp % H);
  const int lane = threadIdx.x % G;
  const unsigned mask = group_mask<G>();
  const int HC = H * C;
  const size_t ldg = static_cast<size_t>(HC + H);
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const float mh = __ldg(m + hd);
  // the row's own node term: d of a receiver, s of a sender
  const float own = __ldg((kSrc ? s : d) + static_cast<size_t>(r) * H + hd);
  const bool stores = !(kAblate & kNoStore) || sink != 0;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  for (int c0 = 0; c0 < C; c0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    float dsum = 0.f;
    // stand-ins for removed gathers: the row's own values, loaded once
    float g_own[kVec] = {};
    float gden_own = 0.f, h_own = 0.f;
    if constexpr (!kGatherG) {
      const float* gr = g + static_cast<size_t>(r) * ldg + hd * C;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = c0 + lane + k * G;
        g_own[k] = c < C ? __ldg(gr + c) : 0.f;
      }
      gden_own = __ldg(g + static_cast<size_t>(r) * ldg + HC + hd);
    }
    if constexpr (!kGatherH) {
      h_own = lane < C ? __ldg(h + static_cast<size_t>(r) * HC + hd * C + lane)
                       : 0.f;
    }
    for (int e = e0; e < e1; ++e) {
      const int other = kIndex ? __ldg(col + e) : r;
      const int id = kSrc ? __ldg(eid + e) : e;
      const int recv = kSrc ? other : r;
      const int send = kSrc ? r : other;
      const float dr =
          kSrc && kGatherS ? __ldg(d + static_cast<size_t>(other) * H + hd)
                           : own;
      const float sv =
          kSrc || !kGatherS ? own
                            : __ldg(s + static_cast<size_t>(other) * H + hd);
      const float zpre = sv + dr;
      const float zl = leaky(zpre, slope) - leaky(mh + dr, slope);
      const float ex = (kAblate & kNoExp) ? zl : expf(zl);
      const float ks = (kAblate & kNoDrop)
                           ? scale
                           : keep_scale(seed, id, hd, thresh, scale);
      const float* gn = g + static_cast<size_t>(recv) * ldg + hd * C;
      if (kSrc) {
        const float w = ex * ks;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int c = c0 + lane + k * G;
          if (c < C) acc[k] += (kGatherG ? __ldg(gn + c) : g_own[k]) * w;
        }
      }
      if (c0 == 0) {
        const float* hs = h + static_cast<size_t>(send) * HC + hd * C;
        float part = 0.f;
        for (int c = lane; c < C; c += G) {
          part += (kGatherG ? __ldg(gn + c) : g_own[0]) *
                  (kGatherH ? __ldg(hs + c) : h_own);
        }
        const float dot =
            (kAblate & kNoShuffle) ? part : group_sum<G>(part, mask);
        const float gden =
            kGatherG ? __ldg(g + static_cast<size_t>(recv) * ldg + HC + hd)
                     : gden_own;
        const float dz = ex * (ks * dot + gden);
        dsum += zpre > 0.f ? dz : slope * dz;
      }
    }
    if (kSrc) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = c0 + lane + k * G;
        if (c < C && stores) {
          dh[static_cast<size_t>(r) * HC + hd * C + c] = acc[k];
        }
      }
    }
    if (c0 == 0 && lane == 0 && stores) {
      out_h[static_cast<size_t>(r) * H + hd] = dsum;
    }
    if (!kSrc) break;  // the receiver side has no per-channel output
  }
}

int blocks_for(int n_rows, int H, int G) {
  const long long groups = static_cast<long long>(n_rows) * H;
  const long long per_block = kThreads / G;
  return static_cast<int>((groups + per_block - 1) / per_block);
}

// Calls f(std::integral_constant<int, G>{}) with the group width of C:
// the smallest power of two >= min(C, 32), and at least 4.
template <typename Fn>
void with_group_width(int C, Fn&& f) {
  if (C <= 4) {
    f(std::integral_constant<int, 4>{});
  } else if (C <= 8) {
    f(std::integral_constant<int, 8>{});
  } else if (C <= 16) {
    f(std::integral_constant<int, 16>{});
  } else {
    f(std::integral_constant<int, 32>{});
  }
}

}  // namespace

// Forward: out (n_rows, H*C + H) = num | den over the receiver-major CSR.
extern "C" int packed_gat_fwd(void* row_ptr, void* col, void* d, void* s,
                              void* h, void* m, void* seed, void* out,
                              int n_rows, int H, int C, unsigned thresh,
                              float scale, float slope, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    with_group_width(C, [&](auto width) {
      constexpr int G = decltype(width)::value;
      gat_fwd_kernel<G><<<blocks_for(n_rows, H, G), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const float*>(m),
          static_cast<const int*>(seed), static_cast<float*>(out), n_rows, H,
          C, thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward over one CSR. src_side = 0: receiver-major CSR, eid unused
// (may be null), writes dd (n_rows, H) into out_h, dh unused. src_side =
// 1: sender-major CSR with its edge ids, writes ds (n_rows, H) into out_h
// and dh (n_rows, H*C).
extern "C" int packed_gat_bwd(void* row_ptr, void* col, void* eid, void* d,
                              void* s, void* h, void* m, void* g, void* seed,
                              void* out_h, void* dh, int n_rows, int H, int C,
                              unsigned thresh, float scale, float slope,
                              int src_side, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    with_group_width(C, [&](auto width) {
      constexpr int G = decltype(width)::value;
      auto kernel = src_side ? gat_bwd_kernel<G, true>
                             : gat_bwd_kernel<G, false>;
      kernel<<<blocks_for(n_rows, H, G), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const int*>(eid), static_cast<const float*>(d),
          static_cast<const float*>(s), static_cast<const float*>(h),
          static_cast<const float*>(m), static_cast<const float*>(g),
          static_cast<const int*>(seed), static_cast<float*>(out_h),
          static_cast<float*>(dh), n_rows, H, C, thresh, scale, slope, 0);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
