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
// operations.
//
// The first design (flash_fwd_kernel, flash_bwd_row_heads_kernel,
// flash_bwd_col_heads_kernel), which the library keeps for the widths the
// row map below does not take:
// - A group of 8 lanes owns one (row, head) pair (the column pass: one
//   (column, head) pair), so a warp works on four pairs at once. Lane l of
//   the group takes the words l, l + 8, ... of the mask row, four at a
//   time (walk_row), and visits their set bits with __ffs: each valid
//   entry's logit, exp and hash are computed once, by one lane, which
//   also keeps its own KC channel sums (KC = 8, or 32 for C > 8;
//   with_channel_chunk). C > 32 takes one walk per chunk of 32 channels,
//   and forms the dot <g, h> of the backward over all C channels from
//   memory on each walk.
// - The forward makes one walk with an online softmax (a lane rescales
//   its sums when it meets a larger logit) where a first walk for the
//   maximum would double the chain; the lanes' (max, sum) pairs are
//   merged after the walk. The lanes' sums meet in reduce_scatter, a
//   fixed tree (gat_mask.cuh).
//
// The row map (flash_fwd_row_kernel, flash_bwd_row_kernel,
// flash_bwd_col_kernel): a warp per mask row over all heads, one lane per
// (entry, head), the map of the block-sparse row pass (bsr_gat.cu) on the
// dense mask, in the forward and both backward passes:
// - The 32 lanes of a warp own one row of the mask (the column pass: one
//   row of the transposed mask) over all H heads, so a row's words are
//   read once, not once per head. A launch holds at most 8192 rows, under
//   one wave of the card at 32 lanes a row, so fewer lanes would only
//   leave more of the card idle (at one head 16 and 8 lanes were slower:
//   PERF.md).
// - decode_chunk: lane l loads the words l, l + 32, ..., kWordsPerLane of
//   them at once, so a row of up to 256 words (8192 nodes) is one round
//   trip, where the first design's groups took three rounds of four words
//   a lane; __popc and a prefix sum over the lanes (skipped for a step of
//   words that holds no entry) give each set bit its rank, and the
//   columns of ranks [start, start + chunk) go to a list in shared
//   memory, in column order. A row with more entries than a chunk (a
//   half-full mask) is taken chunk after chunk; a lane visits the bits of
//   a word only where its ranks meet the chunk.
// - Lane t keeps to head t % H (H dividing 32, C <= 32) and takes every
//   (32 / H)-th entry of a chunk, so each (entry, head) pair is one
//   lane's: it forms the pair's exp, hash and dz once, without a shuffle,
//   and gathers the neighbour's slice of its head as whole 16-byte loads,
//   rows_in_flight entries at once. Forward: d[i] and the salt once per
//   row; a chunk is taken in steps of kFwdPairsPerLane entries a lane,
//   each step's logits in registers, the head's step maximum a fixed tree
//   over its lanes, the running l and sums rescaled once per step, then
//   p, l and keep p h[j] added in the lane's registers; the head's lanes
//   meet after the last chunk and store out as whole head slices, and
//   lse. Row pass: the head's g[i] in
//   registers, D = <g[i], out[i]>, d[i], lse[i] and the salt once per row;
//   per entry h[j] and s[j]. Column pass: the head's h[j] in registers;
//   per entry the g[i] slice, which serves both the dot <g[i], h[j]> and
//   dh[j] += beta g[i], and d, lse and D of (i, head). The entry groups'
//   sums (l and out; dd; ds and dh) meet in a fixed tree of shuffles.
// - D is summed in a group's order and the dot channel after channel, as
//   the first design sums them (gat_mask.cuh: dot_in_group_order), so D
//   and each pair's dz are bitwise the first design's; dd, ds and dh sum
//   the entries in another order (within 1e-6 of the largest magnitude at
//   Cora, 2e-6 on a half-full mask whose sums run over 1,000 terms).
// - The first design stays where this map does not apply: a head count
//   that does not divide 32, or heads wider than 32 channels.
// - The row pass also writes D (n, H), which the column pass reads: the
//   two launches go on one stream, in that order. Every output element is
//   written, rows and columns without entries as 0, so outputs may come
//   from torch.empty. Sums are fixed trees: no atomics, and two launches
//   give bitwise equal results.
// - The seed is read from device memory, so the caller never waits on the
//   card for it. fp32 throughout; expf and logf (not the fast intrinsics)
//   and no fast-math flags, so the kernels hold 1e-5 against the plain
//   PyTorch versions.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, first design -> this one,
// both timed in one run by probes/flash_gat_designs.py (PERF.md): the
// forward at Cora's conv1 shapes (3072 rows, 13.6k valid entries,
// H = C = 8, dropout 0.6) 13.2 -> 5.6 us (bound 0.9), conv2 (1, 7) 10.6
// -> 6.4 (bound 0.4), 8192 rows of PubMed's degree 37.5 -> 13.3 (bound
// 4.0), a half-full mask of 2048 rows 161.9 -> 89.2 (bound 6.0). The
// backward, both passes: Cora conv1 22.6 -> 10.1 us (bound 1.4), conv2
// 16.6 -> 10.5 (bound 0.5), 8192 rows 73.8 -> 23.9 (bound 5.4), the
// half-full mask 371 -> 186 (bound 11.0).
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/flash_gat.py); each launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "gat_mask.cuh"
#include "row_lanes.cuh"

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

// Backward, row pass, the first design: group (i, hd) over row i of the
// mask; writes dd and D = <g[i], out[i]> of the head.
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_row_heads_kernel(const uint32_t* __restrict__ bits,
                           const float* __restrict__ d,
                           const float* __restrict__ s,
                           const float* __restrict__ h,
                           const float* __restrict__ lse,
                           const float* __restrict__ out,
                           const float* __restrict__ g,
                           const int* __restrict__ seed_ptr,
                           float* __restrict__ dd, float* __restrict__ D,
                           int n, int W, int H, int C, uint32_t thresh,
                           float scale, float slope) {
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

// Backward, column pass, the first design: group (j, hd) over row j of the
// transposed mask (bit i of that row: adj[i][j]); writes ds and dh.
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_col_heads_kernel(const uint32_t* __restrict__ bits_t,
                           const float* __restrict__ d,
                           const float* __restrict__ s,
                           const float* __restrict__ h,
                           const float* __restrict__ lse,
                           const float* __restrict__ D,
                           const float* __restrict__ g,
                           const int* __restrict__ seed_ptr,
                           float* __restrict__ ds, float* __restrict__ dh,
                           int n, int W, int H, int C, uint32_t thresh,
                           float scale, float slope) {
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

// Mask words a lane of the sub-warp design loads in one pass of
// decode_chunk, all at once.
constexpr int kWordsPerLane = 8;
// (entry, head) pairs of a column-list chunk, per lane of the row.
constexpr int kPairsPerLane = 32;
// Lanes of a row in the library: a whole warp. A launch of at most
// MAX_NODES = 8192 rows (ops/flash_gat.py) holds 8192 * 32 threads, under
// one wave of the card, so every narrower sub-warp would leave lanes idle.
constexpr int kRowLanes = 32;

__host__ __device__ constexpr int chunk_of(int H, int L) {
  return H < L * kPairsPerLane ? L * kPairsPerLane / H : 1;
}

// Neighbour rows a lane loads before it uses any of them, at KC channels
// of a head in registers.
__host__ __device__ constexpr int rows_in_flight(int KC) {
  return KC > 8 ? 1 : 2;
}

// A row's place in its decode: the first word not yet wholly taken, the
// entries before it, and the rank of the next chunk's first entry.
struct Cursor {
  int word, rank, start;
};

// Writes the columns of the entries of ranks [start, start + chunk) of
// the mask row `bits` (W words) to cols, in order, and returns how many
// there are (chunk, or fewer at the row's end). A pass covers
// kWordsPerLane * L words: lane l loads the words l, l + L, l + 2 L, ...
// of it at once (each load a coalesced line of the warp), and a prefix sum
// over the lanes of each step's __popc gives each set bit its rank, in
// column order; a step without an entry in any lane's word (most of a
// sparse row) takes no prefix sum. A lane visits the bits of a word only
// where the word's ranks meet the chunk. A step that crosses the chunk's
// end is read again by the next chunk.
template <int L>
__device__ __forceinline__ int decode_chunk(const uint32_t* __restrict__ bits,
                                            int W, Cursor& cur, int* cols,
                                            int chunk, const Row<L>& row) {
  row.sync();   // the lanes are done with the previous chunk
  const int end = cur.start + chunk;
  int total = cur.rank;   // entries in the words read so far
  bool full = false;
  while (!full && cur.word < W) {
    uint32_t wd[kWordsPerLane];
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int w = cur.word + k * L + row.lane;
      wd[k] = w < W ? __ldg(bits + w) : 0u;
    }
    // the steps that hold an entry in any lane's word: the others need
    // no prefix sum
    unsigned live = 0u;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      live |= (wd[k] != 0u ? 1u : 0u) << k;
    }
    live = __reduce_or_sync(row.mask, live);
    const int w0 = cur.word;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      if (w0 + k * L >= W) break;   // the same for every lane
      if (!((live >> k) & 1u)) {    // no entry: the chunk is not full yet
        cur.word = w0 + (k + 1) * L;
        cur.rank = total;
        continue;
      }
      const int pc = __popc(wd[k]);
      const int after = total + row.scan(pc);   // entries through my word
      int r = after - pc;
      if (r < end && after > cur.start) {
        uint32_t word = wd[k];
        while (word && r < end) {
          const int bit = __ffs(word) - 1;
          word &= word - 1u;
          if (r >= cur.start) {
            cols[r - cur.start] = (w0 + k * L + row.lane) * 32 + bit;
          }
          ++r;
        }
      }
      total = row.bcast(after, L - 1);
      if (total <= end) {   // the step is wholly inside the chunks so far
        cur.word = w0 + (k + 1) * L;
        cur.rank = total;
      }
      if (total >= end) {
        full = true;
        break;
      }
    }
  }
  const int got = min(chunk, total - cur.start);
  cur.start = end;
  row.sync();
  return max(got, 0);
}

// Entries a lane of the forward takes in one step of a column-list chunk,
// each with its logit in a register.
constexpr int kFwdPairsPerLane = 4;

// Forward of the sub-warp design, where H divides L and C <= KC: the L
// lanes of a sub-warp over row i of the mask, all heads; writes out and
// lse. Lane t keeps to head t % H and takes the entries t / H,
// t / H + L / H, ... of each chunk (see the head of this file), in steps
// of kFwdPairsPerLane entries a lane. Per step: the lane's logits in
// registers; the head's step maximum, a fixed tree over its lanes; the
// running sums rescaled once; then p, l and keep p h[j] summed into the
// lane's registers, rows_in_flight neighbour slices at a time. The
// head's lanes meet in a fixed tree after the last chunk. Only the
// column list goes through shared memory.
template <int L, int V, int KC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_row_kernel(const uint32_t* __restrict__ bits,
                     const float* __restrict__ d, const float* __restrict__ s,
                     const float* __restrict__ h,
                     const int* __restrict__ seed_ptr, float* __restrict__ out,
                     float* __restrict__ lse, int n, int W, int H, int C,
                     uint32_t thresh, float scale, float slope) {
  constexpr int NB = rows_in_flight(KC);
  constexpr int P = kFwdPairsPerLane;
  extern __shared__ int smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int i = blockIdx.x * (blockDim.x / L) + sub;
  if (i >= n) return;
  const int HC = H * C;
  const size_t irow = static_cast<size_t>(i);
  const int chunk = chunk_of(H, L);
  int* cols = smem + sub * chunk;   // senders j
  const int hd = row.lane % H;
  const int r0 = row.lane / H;
  const int R = L / H;
  const size_t ih = irow * H + hd;
  const float di = __ldg(d + ih);
  const uint32_t salt = hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  // the running maximum, and the sums relative to it
  float m_run = -INFINITY, l_run = 0.f, acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  Cursor cur{0, 0, 0};
  const uint32_t* mrow = bits + irow * W;
  for (;;) {
    const int ne = decode_chunk<L>(mrow, W, cur, cols, chunk, row);
    if (ne == 0) break;
    // steps of R P entries, the same count for every lane
    for (int e0 = r0; e0 - r0 < ne; e0 += R * P) {
      float z[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int e = e0 + k * R;
        z[k] = e < ne ? __ldg(s + static_cast<size_t>(cols[e]) * H + hd)
                      : 0.f;
      }
      float zmax = -INFINITY;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (e0 + k * R < ne) {
          z[k] = leaky(di + z[k], slope);
          zmax = fmaxf(zmax, z[k]);
        }
      }
      const float m_new = fmaxf(m_run, row.max_from(zmax, H));
      const float f = expf(m_run - m_new);   // 0 on the first step
      l_run *= f;
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] *= f;
      m_run = m_new;
#pragma unroll
      for (int k0 = 0; k0 < P; k0 += NB) {
        if (e0 + k0 * R >= ne) break;
        float hv[NB][KC];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int e = e0 + (k0 + b) * R;
          const size_t j = e < ne ? static_cast<size_t>(cols[e]) : irow;
          load_head<KC, V>(h + j * HC + hd * C, e < ne ? C : 0, hv[b]);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int e = e0 + (k0 + b) * R;
          if (e >= ne) continue;
          const float p = expf(z[k0 + b] - m_run);
          l_run += p;
          const float wgt =
              keep_scale(salt, i, cols[e], thresh, 1.f) != 0.f ? p : 0.f;
#pragma unroll
          for (int k = 0; k < KC; ++k) acc[k] += wgt * hv[b][k];
        }
      }
    }
    if (ne < chunk) break;
  }
  // the head's lanes meet
  l_run = fmaxf(row.sum_from(l_run, H), 1e-20f);
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = row.sum_from(acc[k], H);
  if (r0 == 0) {
    const float factor = scale / l_run;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] *= factor;
    store_head<KC, V>(out + irow * HC + hd * C, C, acc);
    lse[ih] = (m_run > -INFINITY ? m_run : 0.f) + logf(l_run);
  }
}

// Backward, row pass of the sub-warp design, where H divides L and
// C <= KC: the L lanes of a sub-warp over row i of the mask, all heads;
// writes dd and D. Lane t keeps to head t % H and takes the entries
// t / H, t / H + L / H, ... of each chunk (see the head of this file).
// Only the column list goes through shared memory; the entry groups'
// sums meet in a fixed tree.
template <int L, int V, int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_row_kernel(const uint32_t* __restrict__ bits,
                     const float* __restrict__ d,
                     const float* __restrict__ s, const float* __restrict__ h,
                     const float* __restrict__ lse,
                     const float* __restrict__ out,
                     const float* __restrict__ g,
                     const int* __restrict__ seed_ptr, float* __restrict__ dd,
                     float* __restrict__ D, int n, int W, int H, int C,
                     uint32_t thresh, float scale, float slope) {
  constexpr int NB = rows_in_flight(KC);
  extern __shared__ int smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int i = blockIdx.x * (blockDim.x / L) + sub;
  if (i >= n) return;
  const int HC = H * C;
  const size_t irow = static_cast<size_t>(i);
  const int chunk = chunk_of(H, L);
  int* cols = smem + sub * chunk;   // senders j
  const int hd = row.lane % H;
  const int r0 = row.lane / H;
  const int R = L / H;
  const size_t ih = irow * H + hd;
  const float* gi = g + irow * HC + hd * C;
  float greg[KC];
  load_head<KC, V>(gi, C, greg);
  const float di = __ldg(d + ih);
  const float lse_i = __ldg(lse + ih);
  const uint32_t salt = hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float Di = dot_in_group_order(gi, out + irow * HC + hd * C, C);
  float dd_acc = 0.f;
  Cursor cur{0, 0, 0};
  const uint32_t* mrow = bits + irow * W;
  for (;;) {
    const int ne = decode_chunk<L>(mrow, W, cur, cols, chunk, row);
    if (ne == 0) break;
    // NB entries a lane at once, every load of them issued together
    for (int e0 = r0; e0 < ne; e0 += R * NB) {
      float hv[NB][KC], sv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        const size_t j = e < ne ? static_cast<size_t>(cols[e]) : irow;
        load_head<KC, V>(h + j * HC + hd * C, e < ne ? C : 0, hv[b]);
        sv[b] = e < ne ? __ldg(s + j * H + hd) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        if (e >= ne) continue;
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k < C) dot += greg[k] * hv[b][k];
        }
        const float zpre = di + sv[b];
        const float alpha = expf(leaky(zpre, slope) - lse_i);
        const float ks = keep_scale(salt, i, cols[e], thresh, scale);
        const float dz = alpha * (ks * dot - Di);
        dd_acc += zpre > 0.f ? dz : slope * dz;
      }
    }
    if (ne < chunk) break;
  }
  // the entry groups' sums meet
  dd_acc = row.sum_from(dd_acc, H);
  if (r0 == 0) {
    dd[ih] = dd_acc;
    D[ih] = Di;
  }
}

// Backward, column pass of the sub-warp design, where H divides L and
// C <= KC: the L lanes of a sub-warp over row j of the transposed mask (an
// entry i of that row: the mask's entry (i, j)), all heads; writes ds and
// dh. Lane t keeps to head t % H, holds the head's channels of h[j] in
// registers and takes the entries t / H, t / H + L / H, ... of each chunk:
// per entry it gathers the head's slice of the g[i] row (whole 16-byte
// loads), which serves both the dot <g[i], h[j]> and dh[j] += beta g[i],
// and d, lse and D of (i, head), and forms alpha, keep, beta and dz once,
// without a shuffle. Only the column list goes through shared memory; the
// entry groups' sums meet in a fixed tree.
template <int L, int V, int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_col_kernel(const uint32_t* __restrict__ bits_t,
                     const float* __restrict__ d,
                     const float* __restrict__ s, const float* __restrict__ h,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, const float* __restrict__ g,
                     const int* __restrict__ seed_ptr, float* __restrict__ ds,
                     float* __restrict__ dh, int n, int W, int H, int C,
                     uint32_t thresh, float scale, float slope) {
  constexpr int NB = rows_in_flight(KC);
  extern __shared__ int smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int j = blockIdx.x * (blockDim.x / L) + sub;
  if (j >= n) return;
  const int HC = H * C;
  const size_t jrow = static_cast<size_t>(j);
  const int chunk = chunk_of(H, L);
  int* cols = smem + sub * chunk;   // receivers i
  const int hd = row.lane % H;
  const int r0 = row.lane / H;
  const int R = L / H;
  const size_t jh = jrow * H + hd;
  float hreg[KC];
  load_head<KC, V>(h + jrow * HC + hd * C, C, hreg);
  const float sj = __ldg(s + jh);
  const uint32_t salt = hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  float acc[KC], ds_acc = 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  Cursor cur{0, 0, 0};
  const uint32_t* mrow = bits_t + jrow * W;
  for (;;) {
    const int ne = decode_chunk<L>(mrow, W, cur, cols, chunk, row);
    if (ne == 0) break;
    // NB entries a lane at once, every load of them issued together
    for (int e0 = r0; e0 < ne; e0 += R * NB) {
      float gv[NB][KC], dv[NB], lv[NB], Dv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        const size_t i = e < ne ? static_cast<size_t>(cols[e]) : jrow;
        load_head<KC, V>(g + i * HC + hd * C, e < ne ? C : 0, gv[b]);
        const size_t ih = i * H + hd;
        dv[b] = e < ne ? __ldg(d + ih) : 0.f;
        lv[b] = e < ne ? __ldg(lse + ih) : 0.f;
        Dv[b] = e < ne ? __ldg(D + ih) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        if (e >= ne) continue;
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < KC; ++k) dot += gv[b][k] * hreg[k];
        const float zpre = dv[b] + sj;
        const float alpha = expf(leaky(zpre, slope) - lv[b]);
        const float ks = keep_scale(salt, cols[e], j, thresh, scale);
        const float beta = alpha * ks;
        const float dz = alpha * (ks * dot - Dv[b]);
        ds_acc += zpre > 0.f ? dz : slope * dz;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] += beta * gv[b][k];
      }
    }
    if (ne < chunk) break;
  }
  // the entry groups' sums meet
  ds_acc = row.sum_from(ds_acc, H);
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = row.sum_from(acc[k], H);
  if (r0 == 0) {
    store_head<KC, V>(dh + jrow * HC + hd * C, C, acc);
    ds[jh] = ds_acc;
  }
}

// Launches kernel over n rows of L lanes each, kThreads / L rows a block,
// with `ints` ints of dynamic shared memory a row.
template <int L, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int n, int ints, cudaStream_t stream,
                Args... args) {
  constexpr int rows = kThreads / L;
  const size_t bytes = static_cast<size_t>(rows) * ints * sizeof(int);
  const int grid = (n + rows - 1) / rows;
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The backward's arguments, as flash_gat_bwd_row and flash_gat_bwd_col
// take them: the row pass's (lse, out) -> (dd, D), the column pass's
// (lse, D) -> (ds, dh).
struct BwdArgs {
  const uint32_t* bits;
  const float *d, *s, *h, *lse, *in, *g;
  const int* seed;
  float *o1, *o2;
  int n, W, H, C;
  uint32_t thresh;
  float scale, slope;
  cudaStream_t stream;
};

BwdArgs bwd_args(void* bits, void* d, void* s, void* h, void* lse,
                 void* in, void* g, void* seed, void* o1, void* o2, int n,
                 int W, int H, int C, unsigned thresh, float scale,
                 float slope, void* stream) {
  return BwdArgs{static_cast<const uint32_t*>(bits),
                 static_cast<const float*>(d), static_cast<const float*>(s),
                 static_cast<const float*>(h), static_cast<const float*>(lse),
                 static_cast<const float*>(in), static_cast<const float*>(g),
                 static_cast<const int*>(seed), static_cast<float*>(o1),
                 static_cast<float*>(o2), n, W, H, C, thresh, scale, slope,
                 static_cast<cudaStream_t>(stream)};
}

// The first design of the row pass, at any width.
int launch_row_heads(const BwdArgs& a) {
  with_channel_chunk(a.C, [&](auto chunk) {
    constexpr int KC = decltype(chunk)::value;
    flash_bwd_row_heads_kernel<KC><<<blocks_for(a.n, a.H), kThreads, 0,
                                     a.stream>>>(
        a.bits, a.d, a.s, a.h, a.lse, a.in, a.g, a.seed, a.o1, a.o2, a.n, a.W,
        a.H, a.C, a.thresh, a.scale, a.slope);
  });
  return static_cast<int>(cudaGetLastError());
}

// The first design of the column pass, at any width.
int launch_col_heads(const BwdArgs& a) {
  with_channel_chunk(a.C, [&](auto chunk) {
    constexpr int KC = decltype(chunk)::value;
    flash_bwd_col_heads_kernel<KC><<<blocks_for(a.n, a.H), kThreads, 0,
                                     a.stream>>>(
        a.bits, a.d, a.s, a.h, a.lse, a.in, a.g, a.seed, a.o1, a.o2, a.n, a.W,
        a.H, a.C, a.thresh, a.scale, a.slope);
  });
  return static_cast<int>(cudaGetLastError());
}

// Launches a pass of the sub-warp design (flash_bwd_row_kernel or
// flash_bwd_col_kernel, as Pass<L, V, KC>::kernel gives it) at L lanes a
// row (4, 8, 16 or 32; the library takes kRowLanes), V channels a load
// where the rows are 16-byte aligned (`aligned`); -1 where its map does
// not take (H, C): H must divide L and a head hold at most 32 channels.
template <template <int, int, int> class Pass, int L>
int launch_lanes(const BwdArgs& a, bool aligned) {
  if (a.C > 32 || L % a.H != 0) return -1;
  int rc = -1;
  const auto launch = [&](auto v) {
    constexpr int V = decltype(v)::value;
    with_channel_chunk(a.C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      rc = launch_rows<L>(Pass<L, V, KC>::kernel, a.n, chunk_of(a.H, L),
                          a.stream, a.bits, a.d, a.s, a.h, a.lse, a.in, a.g,
                          a.seed, a.o1, a.o2, a.n, a.W, a.H, a.C, a.thresh,
                          a.scale, a.slope);
    });
  };
  if (channels_per_lane(a.C, aligned) == 4) {
    launch(std::integral_constant<int, 4>{});
  } else {
    launch(std::integral_constant<int, 1>{});
  }
  return rc;
}

template <int L, int V, int KC>
struct RowPass {
  static constexpr auto kernel = flash_bwd_row_kernel<L, V, KC>;
};
template <int L, int V, int KC>
struct ColPass {
  static constexpr auto kernel = flash_bwd_col_kernel<L, V, KC>;
};

// The sub-warp design of the row pass at L lanes a row; -1 where its map
// does not take (H, C).
template <int L = kRowLanes>
int launch_row_lanes(const BwdArgs& a) {
  return launch_lanes<RowPass, L>(
      a, aligned16(a.h) && aligned16(a.g) && aligned16(a.in));
}

// The sub-warp design of the column pass at L lanes a row; -1 where its
// map does not take (H, C).
template <int L = kRowLanes>
int launch_col_lanes(const BwdArgs& a) {
  return launch_lanes<ColPass, L>(
      a, aligned16(a.h) && aligned16(a.g) && aligned16(a.o2));
}

// The forward's arguments, as flash_gat_fwd takes them.
struct FwdArgs {
  const uint32_t* bits;
  const float *d, *s, *h;
  const int* seed;
  float *out, *lse;
  int n, W, H, C;
  uint32_t thresh;
  float scale, slope;
  cudaStream_t stream;
};

FwdArgs fwd_args(void* bits, void* d, void* s, void* h, void* seed,
                 void* out, void* lse, int n, int W, int H, int C,
                 unsigned thresh, float scale, float slope, void* stream) {
  return FwdArgs{static_cast<const uint32_t*>(bits),
                 static_cast<const float*>(d), static_cast<const float*>(s),
                 static_cast<const float*>(h), static_cast<const int*>(seed),
                 static_cast<float*>(out), static_cast<float*>(lse), n, W, H,
                 C, thresh, scale, slope, static_cast<cudaStream_t>(stream)};
}

// The first design of the forward, at any width.
int launch_fwd_heads(const FwdArgs& a) {
  with_channel_chunk(a.C, [&](auto chunk) {
    constexpr int KC = decltype(chunk)::value;
    flash_fwd_kernel<KC><<<blocks_for(a.n, a.H), kThreads, 0, a.stream>>>(
        a.bits, a.d, a.s, a.h, a.seed, a.out, a.lse, a.n, a.W, a.H, a.C,
        a.thresh, a.scale, a.slope);
  });
  return static_cast<int>(cudaGetLastError());
}

// The forward of the sub-warp design at L lanes a row (V channels a load
// where the rows are 16-byte aligned); -1 where its map does not take
// (H, C): H must divide L and a head hold at most 32 channels.
template <int L = kRowLanes>
int launch_fwd_lanes(const FwdArgs& a) {
  if (a.C > 32 || L % a.H != 0) return -1;
  int rc = -1;
  const auto launch = [&](auto v) {
    constexpr int V = decltype(v)::value;
    with_channel_chunk(a.C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      rc = launch_rows<L>(flash_fwd_row_kernel<L, V, KC>, a.n,
                          chunk_of(a.H, L), a.stream, a.bits, a.d, a.s,
                          a.h, a.seed, a.out, a.lse, a.n, a.W, a.H, a.C,
                          a.thresh, a.scale, a.slope);
    });
  };
  if (channels_per_lane(a.C, aligned16(a.h) && aligned16(a.out)) == 4) {
    launch(std::integral_constant<int, 4>{});
  } else {
    launch(std::integral_constant<int, 1>{});
  }
  return rc;
}

}  // namespace

// Forward: out (n, H*C) and lse (n, H) from the bit-packed mask (n, W).
// The sub-warp design where its map takes (H, C); the first design
// elsewhere.
extern "C" int flash_gat_fwd(void* bits, void* d, void* s, void* h,
                             void* seed, void* out, void* lse, int n, int W,
                             int H, int C, unsigned thresh, float scale,
                             float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    const FwdArgs a = fwd_args(bits, d, s, h, seed, out, lse, n, W, H, C,
                               thresh, scale, slope, stream);
    const int rc = launch_fwd_lanes(a);
    return rc >= 0 ? rc : launch_fwd_heads(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, row pass: dd (n, H) and D (n, H) from the mask. The sub-warp
// design where its map takes (H, C); the first design elsewhere.
extern "C" int flash_gat_bwd_row(void* bits, void* d, void* s, void* h,
                                 void* lse, void* out, void* g, void* seed,
                                 void* dd, void* D, int n, int W, int H,
                                 int C, unsigned thresh, float scale,
                                 float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    const BwdArgs a = bwd_args(bits, d, s, h, lse, out, g, seed, dd, D, n, W,
                               H, C, thresh, scale, slope, stream);
    const int rc = launch_row_lanes(a);
    return rc >= 0 ? rc : launch_row_heads(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, column pass: ds (n, H) and dh (n, H*C) from the transposed
// mask and the row pass's D. The sub-warp design where its map takes
// (H, C); the first design elsewhere.
extern "C" int flash_gat_bwd_col(void* bits_t, void* d, void* s, void* h,
                                 void* lse, void* D, void* g, void* seed,
                                 void* ds, void* dh, int n, int W, int H,
                                 int C, unsigned thresh, float scale,
                                 float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    const BwdArgs a = bwd_args(bits_t, d, s, h, lse, D, g, seed, ds, dh, n,
                               W, H, C, thresh, scale, slope, stream);
    const int rc = launch_col_lanes(a);
    return rc >= 0 ? rc : launch_col_heads(a);
  }
  return static_cast<int>(cudaGetLastError());
}
