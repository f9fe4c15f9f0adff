// Device code shared by the masked GAT attention kernels, flash_gat.cu
// (dense bit mask) and bsr_gat.cu (block-sparse bit mask): the leaky
// logit, the dropout hash of (seed, row, column, head), the group of
// lanes that owns one (row, head) pair, its fixed-tree reductions and the
// stores of its sums. Both sources compute one function of the mask's
// entries, so they share this code and agree entry for entry; each keeps
// its own walk over the set bits of a row's mask words, which is where
// the two layouts differ.
//
// The port's build hashes this header with every source that includes it
// (kernels/_build.py), so an edit here rebuilds both libraries.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// Lanes of a group, and the mask words a lane loads at a time.
constexpr int kGroup = 8;
constexpr int kBatch = 4;

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : slope * z;
}

// The part of the hash that a (seed, head) pair fixes.
__device__ __forceinline__ uint32_t hash_salt(uint32_t seed, uint32_t hd) {
  return seed * 0xC2B2AE3Du + hd * 0x27D4EB2Fu;
}

// ops/flash_gat.py:_hash_keep_bits (ops/bsr_gat.py:_keep_bits is the same
// mix), in uint32 arithmetic, of the global row and column.
__device__ __forceinline__ uint32_t hash_keep_bits(uint32_t salt, uint32_t row,
                                                   uint32_t col) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ salt;
  x = (x ^ (x >> 15)) * 0x2C1B3C6Du;
  x = (x ^ (x >> 12)) * 0x297A2D39u;
  return x ^ (x >> 15);
}

// keep * scale of one (row, column, head): scale or 0. With thresh == 0
// every bit pattern is kept, so the hash is skipped.
__device__ __forceinline__ float keep_scale(uint32_t salt, int row, int col,
                                            uint32_t thresh, float scale) {
  if (thresh == 0u) return scale;
  return hash_keep_bits(salt, static_cast<uint32_t>(row),
                        static_cast<uint32_t>(col)) >= thresh
             ? scale
             : 0.f;
}

// This thread's group within its warp: the lanes' mask for shuffles and
// this thread's place in the group.
struct Group {
  unsigned mask;
  int lane;
  __device__ __forceinline__ Group() {
    lane = threadIdx.x & (kGroup - 1);
    mask = ((1u << kGroup) - 1u) << ((threadIdx.x & 31) & ~(kGroup - 1));
  }
  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
      v += __shfl_xor_sync(mask, v, o);
    }
    return v;
  }
  __device__ __forceinline__ float max(float v) const {
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(mask, v, o));
    }
    return v;
  }
};

// One step of reduce_scatter at lane distance O with N live values.
template <int K, int N, int O>
__device__ __forceinline__ void reduce_step(float (&v)[K], const Group& grp,
                                            int& first) {
  if constexpr (O >= 1) {
    constexpr int kHalf = N / 2;
    const bool upper = (grp.lane & O) != 0;
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float send = upper ? v[k] : v[k + kHalf];
      const float keep = upper ? v[k + kHalf] : v[k];
      v[k] = keep + __shfl_xor_sync(grp.mask, send, O);
    }
    first += upper ? kHalf : 0;
    reduce_step<K, kHalf, O / 2>(v, grp, first);
  }
}

// Sums each of the K values (a power of two, at least kGroup) over the
// group's lanes in a fixed tree. Afterwards a lane holds, in
// v[0 .. K / kGroup), the totals of the indices first, first + 1, ...;
// first is returned.
template <int K>
__device__ __forceinline__ int reduce_scatter(float (&v)[K],
                                              const Group& grp) {
  static_assert(K >= kGroup && (K & (K - 1)) == 0, "K: a power of two");
  int first = 0;
  reduce_step<K, K, kGroup / 2>(v, grp, first);
  return first;
}

// The (row, head) pair of this thread's group; false past the end (for
// the whole group at once).
__device__ __forceinline__ bool group_pair(int n, int H, int* r, int* hd) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * (kThreads / kGroup) +
      threadIdx.x / kGroup;
  if (pair >= static_cast<long long>(n) * H) return false;
  *r = static_cast<int>(pair / H);
  *hd = static_cast<int>(pair % H);
  return true;
}

// <a, b> over C channels from memory, by one lane.
__device__ __forceinline__ float dot_from_memory(const float* a,
                                                 const float* b, int C) {
  float dot = 0.f;
  for (int c = 0; c < C; ++c) dot += __ldg(a + c) * __ldg(b + c);
  return dot;
}

// <a, b> over C channels by one lane, in the order in which a group forms
// it (lane l sums the channels l, l + kGroup, ..., then Group::sum's
// tree), so it equals, bit for bit, the D that a group's row pass forms.
__device__ __forceinline__ float dot_in_group_order(const float* a,
                                                   const float* b, int C) {
  static_assert(kGroup == 8, "the tree below is Group::sum's for 8 lanes");
  float p[kGroup];
#pragma unroll
  for (int l = 0; l < kGroup; ++l) p[l] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kGroup) {
#pragma unroll
    for (int l = 0; l < kGroup; ++l) {
      if (c0 + l < C) p[l] += __ldg(a + c0 + l) * __ldg(b + c0 + l);
    }
  }
  return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
}

// Writes the group's sums of acc to dst[c0 .. c0 + KC), as far as C goes.
template <int KC>
__device__ __forceinline__ void store_sums(float (&acc)[KC], float factor,
                                           float* dst, int c0, int C,
                                           const Group& grp) {
  const int first = reduce_scatter<KC>(acc, grp);
#pragma unroll
  for (int r = 0; r < KC / kGroup; ++r) {
    const int c = c0 + first + r;
    if (c < C) dst[c] = acc[r] * factor;
  }
}

// Blocks of kThreads that give every (row, head) pair a group.
inline int blocks_for(int n, int H) {
  const long long pairs = static_cast<long long>(n) * H;
  const long long per_block = kThreads / kGroup;
  return static_cast<int>((pairs + per_block - 1) / per_block);
}

// Calls f(std::integral_constant<int, KC>{}) with the channel chunk of C:
// 8 if that holds C, else 32.
template <typename Fn>
void with_channel_chunk(int C, Fn&& f) {
  if (C <= 8) {
    f(std::integral_constant<int, 8>{});
  } else {
    f(std::integral_constant<int, 32>{});
  }
}

}  // namespace
