// Block-sparse GAT attention for Hopper (sm_90a): the function of
// flash_gat.cu (rank-1 logits, masked row softmax with a saved
// log-sum-exp, dropout hashed from (seed, row, column, head), the weighted
// sum of sender rows, and its backward) over a mask that is stored as its
// active blocks only, so it takes any number of nodes.
//
// Replaces the Pallas kernels pytorch_geometric_tpu/ops/bsr_gat.py:
// _fwd_kernel, _bwd_row_kernel and _bwd_col_kernel. Those stream the
// active (512, 512) int8 blocks of the mask through on-chip memory on a
// sequential grid, carry the running maximum, denominator and sums of a
// row strip in scratch from one block to the next, force a diagonal block
// into every strip so that each output is written, and form the sums as
// bf16 matrix products. A CUDA grid has no order and nothing carries over
// between its blocks, so here a group of lanes owns one (row, head) pair
// and loops over its strip's block list itself; the blocks are small and
// bit-packed; every output element is written by the group that owns it,
// rows and columns that no block touches as 0.
//
// Function, per head hd, for a mask entry (i, j) (edge j -> i):
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
// hash() takes the global row and column (gat_mask.cuh), so the result is
// that of the dense-mask kernels on the same mask, whatever the tile.
//
// The mask (ops/bsr_gat.py:BlockMask): rows in strips of ti, columns in
// tiles of 32 wj; only blocks with an entry are kept, in strip-major
// order. strip_ptr[r] .. strip_ptr[r + 1] are strip r's blocks,
// block_col[k] is block k's column tile, and words holds ti rows of wj
// 32-bit words per block, column 32 w + b of the tile in bit b of word w.
// The forward and the row pass read the mask's blocks, the column pass the
// blocks of its transpose, built the same way. Offsets into words are 64
// bits wide.
//
// What bounds it: a call must read the entries once (4 bytes each as a
// column index, whatever layout holds them) and the node arrays once, and
// does about 2 C + 8 flops per (entry, head) forward, 4 C + 12 backward. A
// citation graph's mask is bound by bytes, a few microseconds at PubMed's
// 24,576 rows and 113k entries, so a call is bound by latency: the chain
// strip_ptr -> (block_col, words) -> the senders' s and h. On an H100 at
// 700 W (chip_smoke.py; PERF.md) the forward, the row pass and the column
// pass take 42, 38 and 44 us at PubMed's conv1 shapes (24,576 rows, 113k
// entries, H = 8, C = 8, dropout 0.6; bounds 4.6, 7.0 and 7.0 us), 7.5,
// 7.1 and 6.9 us at Cora's (bounds 0.6, 0.9, 0.9), and 146, 123 and 129 us
// on a block-dense mask of 16,384 rows and 1.06 M entries (bounds 4.3,
// 5.8, 5.8).
//
// Design (the lanes' work is flash_gat.cu's, the walk differs):
// - A group of 8 lanes owns one (row, head) pair; the column pass one
//   (column, head) pair over the transpose. The words of the row inside
//   its strip's blocks (wj per block) are spread over the lanes, four
//   fetched before any is looked at (walk_strip_row); a lane visits the set
//   bits of its words and keeps its own maximum, denominator and KC channel
//   sums (online softmax along the block list), merged after the walk by a
//   fixed tree of shuffles: no atomics, two launches bitwise equal.
// - A strip without blocks gives an empty walk: out = 0, lse = log(1e-20),
//   dd = 0; in the column pass ds = 0 and dh = 0. Outputs may come from
//   torch.empty.
// - A row fetches one row of words from every block of its strip, so a
//   block more than one row high costs it the zero words that the strip's
//   other rows made active, and saves only column indices. On an H100 at
//   PubMed's RCM-ordered mask the forward takes 42 us with (1, 32) tiles,
//   52 with (4, 32), 63 with (8, 32), 94 with (32, 32) and 210 with
//   (128, 128): the operator's default is one row by one word, which keeps
//   a mask of 0.02% density near one block per entry.
// - Known tails: a hub row's entries are walked by its 8 lanes alone (a row
//   of 3000 entries takes about 200 us), and in a block-dense mask a row's
//   few full words keep half the lanes idle.
// - The row pass also writes D (n, H), which the column pass reads: the
//   two launches go on one stream, in that order. The seed is read from
//   device memory. fp32 throughout, expf and logf, no fast-math flags.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/bsr_gat.py); each launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "gat_mask.cuh"

namespace {

// One direction of a block mask (see the head of this file).
struct Strips {
  const int* strip_ptr;
  const int* block_col;
  const uint32_t* words;
  int ti;
  int wj;
};

Strips strips_of(void* strip_ptr, void* block_col, void* words, int ti,
                 int wj) {
  return Strips{static_cast<const int*>(strip_ptr),
                static_cast<const int*>(block_col),
                static_cast<const uint32_t*>(words), ti, wj};
}

// Calls body(c) for every entry (i, c) of row i: the row's words in the
// blocks of its strip (wj per block), each lane of the group on the words
// lane, lane + kGroup, ..., of which it loads kBatch, and their blocks'
// columns, before it looks at any. The lanes run body apart from each
// other: it must not synchronise.
template <typename Body>
__device__ __forceinline__ void walk_strip_row(const Strips& m, int i,
                                               const Group& grp,
                                               Body&& body) {
  const int r = i / m.ti;
  const int li = i - r * m.ti;
  const int k0 = __ldg(m.strip_ptr + r);
  const int count = (__ldg(m.strip_ptr + r + 1) - k0) * m.wj;
  for (int t0 = grp.lane; t0 < count; t0 += kGroup * kBatch) {
    uint32_t words[kBatch];
    int base[kBatch];   // the column of a word's bit 0
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = t0 + b * kGroup;
      words[b] = 0u;
      base[b] = 0;
      if (t < count) {
        const int kb = t / m.wj;
        const int w = t - kb * m.wj;
        const size_t k = static_cast<size_t>(k0) + kb;
        words[b] = __ldg(m.words + (k * m.ti + li) * m.wj + w);
        base[b] = (__ldg(m.block_col + k) * m.wj + w) * 32;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      uint32_t word = words[b];
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1u;
        body(base[b] + bit);
      }
    }
  }
}

// Forward: group (i, hd) over row i of the mask.
template <int KC>
__global__ void __launch_bounds__(kThreads)
bsr_fwd_kernel(Strips mask, const float* __restrict__ d,
               const float* __restrict__ s, const float* __restrict__ h,
               const int* __restrict__ seed_ptr, float* __restrict__ out,
               float* __restrict__ lse, int n, int H, int C, uint32_t thresh,
               float scale, float slope) {
  int i, hd;
  if (!group_pair(n, H, &i, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float di = __ldg(d + static_cast<size_t>(i) * H + hd);

  for (int c0 = 0; c0 < C; c0 += KC) {
    // this lane's running maximum, and its sums relative to it
    float m = -INFINITY, l = 0.f, acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    walk_strip_row(mask, i, grp, [&](int j) {
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
bsr_bwd_row_kernel(Strips mask, const float* __restrict__ d,
                   const float* __restrict__ s, const float* __restrict__ h,
                   const float* __restrict__ lse,
                   const float* __restrict__ out,
                   const float* __restrict__ g,
                   const int* __restrict__ seed_ptr, float* __restrict__ dd,
                   float* __restrict__ D, int n, int H, int C,
                   uint32_t thresh, float scale, float slope) {
  int i, hd;
  if (!group_pair(n, H, &i, &hd)) return;
  const Group grp;
  const int HC = H * C;
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
  walk_strip_row(mask, i, grp, [&](int j) {
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
// (an entry i of that row: the mask's entry (i, j)); writes ds and dh.
template <int KC>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_col_kernel(Strips mask_t, const float* __restrict__ d,
                   const float* __restrict__ s, const float* __restrict__ h,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, const float* __restrict__ g,
                   const int* __restrict__ seed_ptr, float* __restrict__ ds,
                   float* __restrict__ dh, int n, int H, int C,
                   uint32_t thresh, float scale, float slope) {
  int j, hd;
  if (!group_pair(n, H, &j, &hd)) return;
  const Group grp;
  const int HC = H * C;
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
    walk_strip_row(mask_t, j, grp, [&](int i) {
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

// Forward: out (n, H*C) and lse (n, H) from the mask's blocks.
extern "C" int bsr_gat_fwd(void* strip_ptr, void* block_col, void* words,
                           void* d, void* s, void* h, void* seed, void* out,
                           void* lse, int n, int ti, int wj, int H, int C,
                           unsigned thresh, float scale, float slope,
                           void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      bsr_fwd_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
          strips_of(strip_ptr, block_col, words, ti, wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const int*>(seed),
          static_cast<float*>(out), static_cast<float*>(lse), n, H, C,
          thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, row pass: dd (n, H) and D (n, H) from the mask's blocks.
extern "C" int bsr_gat_bwd_row(void* strip_ptr, void* block_col, void* words,
                               void* d, void* s, void* h, void* lse,
                               void* out, void* g, void* seed, void* dd,
                               void* D, int n, int ti, int wj, int H, int C,
                               unsigned thresh, float scale, float slope,
                               void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      bsr_bwd_row_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
          strips_of(strip_ptr, block_col, words, ti, wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const float*>(lse),
          static_cast<const float*>(out), static_cast<const float*>(g),
          static_cast<const int*>(seed), static_cast<float*>(dd),
          static_cast<float*>(D), n, H, C, thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, column pass: ds (n, H) and dh (n, H*C) from the blocks of the
// transposed mask and the row pass's D.
extern "C" int bsr_gat_bwd_col(void* strip_ptr_t, void* block_col_t,
                               void* words_t, void* d, void* s, void* h,
                               void* lse, void* D, void* g, void* seed,
                               void* ds, void* dh, int n, int ti, int wj,
                               int H, int C, unsigned thresh, float scale,
                               float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      bsr_bwd_col_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
          strips_of(strip_ptr_t, block_col_t, words_t, ti, wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const float*>(lse),
          static_cast<const float*>(D), static_cast<const float*>(g),
          static_cast<const int*>(seed), static_cast<float*>(ds),
          static_cast<float*>(dh), n, H, C, thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}
