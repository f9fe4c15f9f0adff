// Dense-mask GAT attention for Hopper (sm_90a): rank-1 logits, masked row
// softmax with a saved log-sum-exp, dropout hashed from (seed, row, column,
// head), the weighted sum of sender rows, and its backward.
//
// Replaces the Pallas kernels pytorch_geometric_tpu/ops/flash_gat.py:
// _fwd_kernel and _bwd_kernel. Those stream (128, N) row tiles of a bf16
// 0/1 mask through on-chip memory, build every (row, column) logit, and
// form the sums as bf16 matrix products; the backward adds its column sums
// into ds and dh from one sequential grid step to the next. A CUDA grid
// has no order, so the backward here is two kernels: a row pass over the
// mask (dd) and a column pass over the transposed mask (ds, dh).
//
// Function, per head hd, for adj[i][j] true (edge j -> i):
//   zpre = d[i] + s[j];  z = leaky(zpre)
//   m_i = max_j z;  p = exp(z - m_i);  l_i = sum_j p   (before dropout)
//   keep = hash(seed, i, j, hd) >= thresh
//   out[i] = (sum_j keep p h[j]) * scale / max(l_i, 1e-20)
//   lse[i] = m_i + log(max(l_i, 1e-20))       (m_i = 0 for an empty row)
// backward, from g = d loss / d out:
//   alpha = exp(z - lse[i]);  ks = keep ? scale : 0
//   D[i] = <g[i], out[i]>;  dot = <g[i], h[j]>    (the head's C channels)
//   dz = alpha * (ks * dot - D[i]) * (zpre > 0 ? 1 : slope)
//   dd[i] = sum_j dz;  ds[j] = sum_i dz;  dh[j] = sum_i alpha ks g[i]
// hash() is ops/flash_gat.py:_hash_keep_bits in uint32 arithmetic, the
// same function of the global coordinates in all three kernels.
//
// The mask is bit-packed: word w of row i holds columns 32 w .. 32 w + 31,
// column 32 w + b in bit b; bits past column n are 0. The row pass and the
// forward read the mask, the column pass its transpose in the same layout.
// At 3072 nodes a mask is 1.2 MB and at 8192 nodes 8.4 MB, so it stays in
// the 50 MB L2, and a zero word skips 32 positions: a call costs
// O(n^2 / 32) bits of mask read plus O(valid entries * H * C) arithmetic,
// for a sparse mask and a dense one alike.
//
// What bounds it: a call must read the mask once (n^2 / 8 bytes) and the
// node arrays once, and does about 2 C + 8 flops per valid (entry, head)
// forward, 4 C + 12 backward. A citation graph's mask (0.1% valid) is
// bound by bytes, about a microsecond at 3072 nodes, so a call there is
// bound by latency and by how many lanes have work: the dependent loads
// of a row's words, then of its senders. A half-full mask is bound by
// operations. On an H100 at 700 W (chip_smoke.py; PERF.md) the forward
// takes 14 us and the backward, two launches, 24 us at Cora's conv1
// shapes (3072 rows, 13.6k valid entries, H = 8, C = 8; bounds 0.9 and
// 1.4 us), 41 and 76 us at 8192 rows of PubMed's degree (bounds 4.0 and
// 5.4 us), and 162 and 371 us on a half-full mask of 2048 rows (bounds
// 6.0 and 11.0 us).
//
// Design:
// - A group of 8 lanes owns one (row, head) pair (the column pass: one
//   (column, head) pair), so a warp works on four pairs at once. Lane l of
//   the group takes the words l, l + 8, ... of the mask row, four at a
//   time (walk_row), and visits their set bits with __ffs: each valid
//   entry's logit, exp and hash are computed once, by one lane, which
//   also keeps its own KC channel sums (KC = 8, or 32 for C > 8;
//   with_channel_chunk). C > 32 takes one walk per chunk of 32 channels,
//   and forms the dot <g, h> of the backward over all C channels from
//   memory on each walk.
// - A call on a sparse mask is a chain of loads that wait for each other
//   (a row's words, then its senders' s and h), and its time follows the
//   length of that chain. So a lane loads four words before it looks at
//   any, the entries of a row are spread over the lanes, and the forward
//   makes one walk with an online softmax (a lane rescales its sums when
//   it meets a larger logit) where a first walk for the maximum would
//   double the chain. The lanes' (max, sum) pairs are merged after the
//   walk.
// - The lanes' sums meet in reduce_scatter, a butterfly within the group
//   in which each step sends half of a lane's values and keeps the other
//   half: 7 shuffles for 8 values. It is a fixed tree: no atomics, and two
//   launches give bitwise equal results. Every output element is written,
//   rows and columns without entries as 0, so outputs may come from
//   torch.empty.
// - The row pass also writes D (n, H), which the column pass reads: the
//   two launches go on one stream, in that order.
// - The seed is read from device memory, so the caller never waits on the
//   card for it. fp32 throughout; expf and logf (not the fast intrinsics)
//   and no fast-math flags, so the kernels hold 1e-5 against the plain
//   PyTorch versions.
// The designs that were measured and dropped are in PERF.md. The hash and
// the group's reductions live in gat_mask.cuh, shared with the
// block-sparse kernels of bsr_gat.cu.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/flash_gat.py); each launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "gat_mask.cuh"

namespace {

// Calls body(c) for every set bit c of a mask row of W words, each lane of
// the group on the words lane, lane + kGroup, ..., of which it loads
// kBatch before it looks at any. The lanes run body apart from each
// other: it must not synchronise.
template <typename Body>
__device__ __forceinline__ void walk_row(const uint32_t* __restrict__ row,
                                         int W, const Group& grp,
                                         Body&& body) {
  for (int w0 = grp.lane; w0 < W; w0 += kGroup * kBatch) {
    uint32_t words[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int w = w0 + b * kGroup;
      words[b] = w < W ? __ldg(row + w) : 0u;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      uint32_t word = words[b];
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1u;
        body((w0 + b * kGroup) * 32 + bit);
      }
    }
  }
}

// Forward: group (i, hd) over row i of the mask.
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint32_t* __restrict__ bits,
                 const float* __restrict__ d, const float* __restrict__ s,
                 const float* __restrict__ h,
                 const int* __restrict__ seed_ptr, float* __restrict__ out,
                 float* __restrict__ lse, int n, int W, int H, int C,
                 uint32_t thresh, float scale, float slope) {
  int i, hd;
  if (!group_pair(n, H, &i, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t* row = bits + static_cast<size_t>(i) * W;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float di = __ldg(d + static_cast<size_t>(i) * H + hd);

  for (int c0 = 0; c0 < C; c0 += KC) {
    // this lane's running maximum, and its sums relative to it
    float m = -INFINITY, l = 0.f, acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    walk_row(row, W, grp, [&](int j) {
      const float z =
          leaky(di + __ldg(s + static_cast<size_t>(j) * H + hd), slope);
      const float* hj = h + static_cast<size_t>(j) * HC + hd * C + c0;
      if (z > m) {
        const float shrink = expf(m - z);   // 0 on the first entry
        l *= shrink;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] *= shrink;
        m = z;
      }
      const float p = expf(z - m);
      l += p;
      const float wgt = keep_scale(salt, i, j, thresh, 1.f) != 0.f ? p : 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (c0 + k < C) acc[k] += wgt * __ldg(hj + k);
      }
    });
    // merge the lanes: bring each to the row's maximum, then add
    const float m_row = grp.max(m);
    const bool any = m_row > -INFINITY;
    const float shrink = any ? expf(m - m_row) : 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] *= shrink;
    l = fmaxf(grp.sum(l * shrink), 1e-20f);
    store_sums<KC>(acc, scale / l,
                   out + static_cast<size_t>(i) * HC + hd * C, c0, C, grp);
    if (c0 == 0 && grp.lane == 0) {
      lse[static_cast<size_t>(i) * H + hd] = (any ? m_row : 0.f) + logf(l);
    }
  }
}

// Backward, row pass: group (i, hd) over row i of the mask; writes dd and
// D = <g[i], out[i]> of the head.
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_row_kernel(const uint32_t* __restrict__ bits,
                     const float* __restrict__ d, const float* __restrict__ s,
                     const float* __restrict__ h,
                     const float* __restrict__ lse,
                     const float* __restrict__ out,
                     const float* __restrict__ g,
                     const int* __restrict__ seed_ptr, float* __restrict__ dd,
                     float* __restrict__ D, int n, int W, int H, int C,
                     uint32_t thresh, float scale, float slope) {
  int i, hd;
  if (!group_pair(n, H, &i, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t* row = bits + static_cast<size_t>(i) * W;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const size_t ih = static_cast<size_t>(i) * H + hd;
  const float di = __ldg(d + ih);
  const float lse_i = __ldg(lse + ih);
  const float* gi = g + static_cast<size_t>(i) * HC + hd * C;
  const float* oi = out + static_cast<size_t>(i) * HC + hd * C;

  float part = 0.f;
  for (int c = grp.lane; c < C; c += kGroup) {
    part += __ldg(gi + c) * __ldg(oi + c);
  }
  const float Di = grp.sum(part);

  const bool in_regs = C <= KC;   // the head's g row fits the registers
  float greg[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) greg[k] = k < C ? __ldg(gi + k) : 0.f;

  float sum = 0.f;
  walk_row(row, W, grp, [&](int j) {
    const float zpre = di + __ldg(s + static_cast<size_t>(j) * H + hd);
    const float* hj = h + static_cast<size_t>(j) * HC + hd * C;
    float dot = 0.f;
    if (in_regs) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < C) dot += greg[k] * __ldg(hj + k);
      }
    } else {
      dot = dot_from_memory(gi, hj, C);
    }
    const float alpha = expf(leaky(zpre, slope) - lse_i);
    const float ks = keep_scale(salt, i, j, thresh, scale);
    const float dz = alpha * (ks * dot - Di);
    sum += zpre > 0.f ? dz : slope * dz;
  });
  sum = grp.sum(sum);
  if (grp.lane == 0) {
    dd[ih] = sum;
    D[ih] = Di;
  }
}

// Backward, column pass: group (j, hd) over row j of the transposed mask
// (bit i of that row: adj[i][j]); writes ds and dh.
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_col_kernel(const uint32_t* __restrict__ bits_t,
                     const float* __restrict__ d, const float* __restrict__ s,
                     const float* __restrict__ h,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, const float* __restrict__ g,
                     const int* __restrict__ seed_ptr, float* __restrict__ ds,
                     float* __restrict__ dh, int n, int W, int H, int C,
                     uint32_t thresh, float scale, float slope) {
  int j, hd;
  if (!group_pair(n, H, &j, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t* row = bits_t + static_cast<size_t>(j) * W;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float sj = __ldg(s + static_cast<size_t>(j) * H + hd);
  const float* hj = h + static_cast<size_t>(j) * HC + hd * C;

  const bool in_regs = C <= KC;   // the head's h row fits the registers
  float hreg[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) hreg[k] = k < C ? __ldg(hj + k) : 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    float acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    float sum = 0.f;
    walk_row(row, W, grp, [&](int i) {
      const size_t ih = static_cast<size_t>(i) * H + hd;
      const float zpre = __ldg(d + ih) + sj;
      const float lse_i = __ldg(lse + ih);
      const float Di = __ldg(D + ih);
      const float* gi = g + static_cast<size_t>(i) * HC + hd * C;
      float gv[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        gv[k] = c0 + k < C ? __ldg(gi + c0 + k) : 0.f;
      }
      float dot = 0.f;
      if (in_regs) {
#pragma unroll
        for (int k = 0; k < KC; ++k) dot += gv[k] * hreg[k];
      } else {
        dot = dot_from_memory(gi, hj, C);
      }
      const float alpha = expf(leaky(zpre, slope) - lse_i);
      const float ks = keep_scale(salt, i, j, thresh, scale);
      const float beta = alpha * ks;
      const float dz = alpha * (ks * dot - Di);
      sum += zpre > 0.f ? dz : slope * dz;
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] += beta * gv[k];
    });
    store_sums<KC>(acc, 1.f, dh + static_cast<size_t>(j) * HC + hd * C, c0,
                   C, grp);
    if (c0 == 0) {
      sum = grp.sum(sum);
      if (grp.lane == 0) ds[static_cast<size_t>(j) * H + hd] = sum;
    }
  }
}

}  // namespace

// Forward: out (n, H*C) and lse (n, H) from the bit-packed mask (n, W).
extern "C" int flash_gat_fwd(void* bits, void* d, void* s, void* h,
                             void* seed, void* out, void* lse, int n, int W,
                             int H, int C, unsigned thresh, float scale,
                             float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      flash_fwd_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(bits), static_cast<const float*>(d),
          static_cast<const float*>(s), static_cast<const float*>(h),
          static_cast<const int*>(seed), static_cast<float*>(out),
          static_cast<float*>(lse), n, W, H, C, thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, row pass: dd (n, H) and D (n, H) from the mask.
extern "C" int flash_gat_bwd_row(void* bits, void* d, void* s, void* h,
                                 void* lse, void* out, void* g, void* seed,
                                 void* dd, void* D, int n, int W, int H,
                                 int C, unsigned thresh, float scale,
                                 float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      flash_bwd_row_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(bits), static_cast<const float*>(d),
          static_cast<const float*>(s), static_cast<const float*>(h),
          static_cast<const float*>(lse), static_cast<const float*>(out),
          static_cast<const float*>(g), static_cast<const int*>(seed),
          static_cast<float*>(dd), static_cast<float*>(D), n, W, H, C, thresh,
          scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, column pass: ds (n, H) and dh (n, H*C) from the transposed
// mask and the row pass's D.
extern "C" int flash_gat_bwd_col(void* bits_t, void* d, void* s, void* h,
                                 void* lse, void* D, void* g, void* seed,
                                 void* ds, void* dh, int n, int W, int H,
                                 int C, unsigned thresh, float scale,
                                 float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      flash_bwd_col_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(bits_t), static_cast<const float*>(d),
          static_cast<const float*>(s), static_cast<const float*>(h),
          static_cast<const float*>(lse), static_cast<const float*>(D),
          static_cast<const float*>(g), static_cast<const int*>(seed),
          static_cast<float*>(ds), static_cast<float*>(dh), n, W, H, C,
          thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
