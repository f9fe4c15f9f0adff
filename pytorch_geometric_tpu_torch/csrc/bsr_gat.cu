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
// between its blocks, so here the lanes of one row loop over its strip's
// block list themselves; the blocks are small and bit-packed; every
// output element is written by the lanes that own its row, rows and
// columns that no block touches as 0.
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
// 24,576 rows and 113k entries (bounds 4.6 us forward, 7.0 backward at
// H = C = 8), so a call is bound by latency: each row is a chain of
// dependent loads, strip_ptr -> (block_col, words) -> the senders' s and
// h (the column pass: d, lse, D and g) -> the stores, and clock64 reads of
// each phase on an H100 put one such step at 1,500-4,000 cycles when
// every row of the launch waits on it at once.
//
// Design of the three kernels (bsr_fwd_kernel, bsr_bwd_row_kernel,
// bsr_bwd_col_kernel, and at other widths bsr_bwd_row_heads_kernel and
// bsr_bwd_col_pairs_kernel):
// - The L lanes of a sub-warp own one row (the column pass: one column,
//   a row of the transposed mask) over all H heads, so the mask is read
//   once per row, not once per head. L is the fewest of 4, 8, 16, 32 that
//   hold the row's H C channels at V a lane and at least H
//   (lanes_per_row): 16 at H = C = 8, 4 at (1, 3), so narrow rows share a
//   warp; twice that where the launch fills less than one wave of the
//   card, which is then bound by its longest row (Cora; hub rows).
// - decode_chunk: each lane loads one word of the row and its block's
//   column, L words a pass; __popc and a prefix sum over the lanes give
//   each set bit its rank, and the columns of ranks [start, start + chunk)
//   go to a list in shared memory. chunk_of(H, L) is 16 (entry, head)
//   pairs a lane: small, so that a row's shared memory is small and many
//   rows are in flight. A longer row (a hub, a block-dense community) is
//   taken chunk after chunk; the per-head maximum, denominator and sums
//   carry over in a fixed order (a chunk's sums are added whole to the
//   running ones), so there are no atomics and two launches are bitwise
//   equal.
// - Forward: the per-(entry, head) logits are formed once, kLoads pairs a
//   lane with their loads issued together. Where H divides L a lane keeps
//   to one head and the chunk's maximum and denominator are shuffles over
//   that head's lanes; else one lane per head walks the chunk's logits in
//   shared memory. The weights go to shared memory beside the list, and
//   the sums so far are rescaled once per chunk.
// - The gather reads whole sender rows: le lanes (a power of two) share a
//   row of H C floats, V = 4 channels a lane as one 16-byte load where C
//   is a multiple of 4 and the rows are 16-byte aligned, else one float
//   (row_lanes.cuh: Lanes, lanes_of); L / le entries go at once, rows_of(V)
//   of them a lane with their loads issued together (the first ones
//   beside the logits' loads), and each lane keeps its channels' sums in
//   registers in a fixed order. The row's sums then meet in a fixed tree
//   of shuffles and are stored as one row. A row wider than its lanes is
//   taken in windows of channels, each a walk.
// - Column pass where the channels of each head lie on cv = C / V
//   neighbouring lanes (a power of two) and one pass covers the row, or
//   H = 1 (bsr_bwd_col_kernel, the main path's widths): one gathered g[i]
//   row serves both the dot <g[i], h[j]> of each head (a sum over its cv
//   lanes) and dh[j] += beta g[i], and each lane forms its head's alpha,
//   keep and beta itself from d, lse and D of (i, head), loaded beside the
//   row: nothing but the column list goes through shared memory, and
//   h[j] is loaded once per column. Otherwise (bsr_bwd_col_pairs_kernel)
//   the (entry, head) terms are formed first, one pair a lane (the dot
//   from memory), and kept in shared memory for the gather of g[i].
// - A row without entries gives out = 0, lse = log(1e-20); a column
//   without entries ds = 0 and dh = 0. Outputs may come from torch.empty.
// - Measured and not kept (probes/bsr_gat_designs.py): the forward on a
//   persistent grid that copies the next tile of rows' mask into shared
//   memory with cp.async while it runs the current one (its 118
//   registers cost more than the step it hides), four words a lane per
//   decode pass, and whole-row gathers by lanes by entry for one-head
//   rows.
//
// - Row pass (bsr_bwd_row_kernel, where H > 1 divides L and C <= 32: the
//   main path's conv1): lane t of the sub-warp keeps to head t % H and
//   takes every (L / H)-th entry of a chunk, so each (entry, head) pair is
//   one lane's. It holds the head's channels of g[i] in registers, forms
//   D = <g[i], out[i]> and loads d[i], lse[i] and the salt once per row,
//   and per entry gathers the head's slice of the h[j] row as whole
//   16-byte loads (kRowRows entries a lane in flight) and s[j], and forms
//   the dot, exp, hash and dz once, without a shuffle. D is summed in a
//   group's order and the dot channel after channel, as the dense-mask
//   kernels sum them (gat_mask.cuh), so that the two agree entry for
//   entry: spread over the lanes of a head and summed in a tree, dd moved
//   by up to 9e-7 of its largest magnitude (rows whose terms cancel, as
//   D = sum alpha ks dot), and the dot passed along those lanes instead
//   cost 27% (PERF.md). The row pass also writes D (n, H), which the
//   column pass reads: the two launches go on one stream, in that order.
// - The row pass keeps its first design (bsr_bwd_row_heads_kernel: a
//   group of 8 lanes per (row, head) that walks the words of its strip
//   itself, walk_strip_row) for one head, where a sub-warp design was
//   slower in one run (RCM-PubMed conv2 (1, 3) 9.2 -> 11.6 us, Cora
//   (1, 7) 4.3 -> 7.0: with one head nothing is shared, and the decode
//   into shared memory costs more than it saves), and where the head
//   count does not divide the lanes or a head is wider than 32 channels,
//   for which it needs no third kernel.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, warm device us per call,
// first design -> this one, both timed in one run by
// probes/bsr_gat_designs.py (PERF.md): RCM-PubMed conv1 (24,576 rows,
// 113k entries, H = C = 8, dropout 0.6) forward 42.3 -> 20.7, column pass
// 42.1 -> 20.5 (bounds 4.6 and 7.0); conv2 (1, 3) 10.6 -> 11.5 and 9.8
// -> 11.8; Cora (8, 8) 7.4 -> 5.9 and 6.7 -> 5.6, (1, 7) 5.0 -> 5.4 and
// 4.5 -> 6.6; a block-dense mask of 16,384 rows and 1.06 M entries 145 ->
// 72 and 127 -> 88; a mask with a hub row and column of ~2,240 entries
// 204 -> 314 and 145 -> 378 (those rows walk 32 lanes' chunks one after
// another, where the first design put 8 groups on each). The row pass,
// redesigned later and timed the same way: conv1 38.6 -> 15.5 (bound
// 7.0), Cora (8, 8) 6.9 -> 4.6, the block-dense mask 122 -> 55, the hub
// mask 167 -> 172. The seed is read from device memory. fp32
// throughout, expf and logf, no fast-math flags.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/bsr_gat.py); each launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "gat_mask.cuh"
#include "row_lanes.cuh"

namespace {

// One direction of a block mask (see the head of this file), and the
// reads of it that the forward and the column pass make (a copy staged in
// shared memory offers the same: probes/bsr_gat_designs.cu).
struct Strips {
  const int* strip_ptr;
  const int* block_col;
  const uint32_t* words;
  int ti;
  int wj;
  __device__ __forceinline__ int strip_start(int r) const {
    return __ldg(strip_ptr + r);
  }
  __device__ __forceinline__ int column_tile(size_t k) const {
    return __ldg(block_col + k);
  }
  __device__ __forceinline__ uint32_t word(size_t k, int li, int w) const {
    return __ldg(words + (k * ti + li) * wj + w);
  }
};

Strips strips_of(void* strip_ptr, void* block_col, void* words, int ti,
                 int wj) {
  return Strips{static_cast<const int*>(strip_ptr),
                static_cast<const int*>(block_col),
                static_cast<const uint32_t*>(words), ti, wj};
}

// (entry, head) pairs of a chunk, per lane of the row: the column list of
// a chunk has chunk_of(H, L) entries, and a longer row is decoded and
// summed a chunk at a time (bsr_gat_chunk gives the length to the tests).
// Small, so that the shared memory of a row is small and many rows are in
// flight on an SM.
constexpr int kPairsPerLane = 16;
// (entry, head) pairs a lane loads before it uses any of them.
constexpr int kLoads = 4;

__host__ __device__ constexpr int chunk_of(int H, int L) {
  return H < L * kPairsPerLane ? L * kPairsPerLane / H : 1;
}

// Sender rows a lane loads before it uses any of them (V channels of
// each).
__host__ __device__ constexpr int rows_of(int V) { return V == 4 ? 2 : 4; }

// Floats of shared memory that one row's lanes use: the column list, the
// per-(entry, head) values of a chunk (the forward's weights; the column
// pass's beta and dz where it forms them apart from the gather) and the
// per-head values.
__host__ __device__ constexpr int fwd_floats(int H, int L) {
  return chunk_of(H, L) * (1 + H) + 3 * H;
}
__host__ __device__ constexpr int col_pairs_floats(int H, int L) {
  return chunk_of(H, L) * (1 + 2 * H) + H;
}

// A row's place in its mask: its words (count, in the blocks of its strip
// from k0, row li of each), the first word not yet wholly decoded and the
// entries before it, and the rank of the next chunk's first entry.
struct Cursor {
  size_t k0;
  int li, count, word, rank, start;
};

template <typename M>
__device__ __forceinline__ Cursor cursor_of(const M& m, int i) {
  const int r = m.ti == 1 ? i : i / m.ti;
  const int k0 = m.strip_start(r);
  return Cursor{static_cast<size_t>(k0), i - r * m.ti,
                (m.strip_start(r + 1) - k0) * m.wj, 0, 0, 0};
}

// Writes the columns of the row's entries of ranks [start, start +
// chunk) to cols, in order, and returns how many there are (chunk, or
// fewer at the row's end). Each lane takes one word of the row and its
// block's column, L words a pass; __popc and a prefix sum over the lanes
// give each set bit its rank. A word that crosses the chunk's end is read
// again by the next chunk.
template <int L, typename M>
__device__ __forceinline__ int decode_chunk(const M& m, Cursor& cur,
                                            int* cols, int chunk,
                                            const Row<L>& row) {
  row.sync();   // the lanes are done with the previous chunk
  const int end = cur.start + chunk;
  int seen = cur.rank;   // entries in the words read so far
  while (cur.word < cur.count) {
    const int t = cur.word + row.lane;
    const bool valid = t < cur.count;
    uint32_t bits = 0u;
    int base = 0;   // the column of the word's bit 0
    if (valid) {
      const int kb = m.wj == 1 ? t : t / m.wj;
      const int w = t - kb * m.wj;
      const size_t k = cur.k0 + kb;
      bits = m.word(k, cur.li, w);
      base = (m.column_tile(k) * m.wj + w) * 32;
    }
    const int pc = __popc(bits);
    const int after = cur.rank + row.scan(pc);   // entries through this word
    int r = after - pc;
    if (r < end && after > cur.start) {
      while (bits) {
        const int bit = __ffs(bits) - 1;
        bits &= bits - 1u;
        if (r >= cur.start && r < end) cols[r - cur.start] = base + bit;
        ++r;
      }
    }
    seen = row.bcast(after, L - 1);
    // the words wholly inside the chunks so far: a prefix of the lanes
    const int live = min(L, cur.count - cur.word);
    const int done = __popc(row.ballot(valid && after <= end));
    const int rank = row.bcast(after, done > 0 ? done - 1 : 0);
    if (done > 0) cur.rank = rank;
    cur.word += done;
    if (done < live) break;   // the chunk is full
  }
  const int got = min(chunk, seen - cur.start);
  cur.start = end;
  row.sync();
  return max(got, 0);
}

// The lane map of a launch, chosen on the host from (H, C) (lanes_of):
// le lanes share one row of H C channels, V channels each, so a pass
// covers the win = le V channels from c0, and L / le entries go at once.
// cv > 0: the channels of each head lie on cv neighbouring lanes and one
// pass covers the row.
struct Lanes {
  int le, win, cv;
};

// Loads this lane's channels from c of the rows src[cols[e]], e = e0 + b
// R (b < NB), into x, all before any is used; 0 past ne or where c < 0.
template <int NB, int V>
__device__ __forceinline__ void load_rows(float (&x)[NB][V],
                                          const float* src, const int* cols,
                                          int e0, int R, int ne, int HC,
                                          int c) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int e = e0 + b * R;
    if (e < ne && c >= 0) {
      load_vec<V>(src + static_cast<size_t>(cols[e]) * HC + c, x[b]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[b][v] = 0.f;
    }
  }
}

// The forward's arguments beside the mask.
struct FwdArgs {
  const float* d;
  const float* s;
  const float* h;
  const int* seed;
  float* out;
  float* lse;
  int n, H, C;
  Lanes lanes;
  uint32_t thresh;
  float scale, slope;
};

// Forward of row i by the L lanes of this thread's sub-warp, all heads,
// with `base` the row's fwd_floats(H, L) floats of shared memory.
template <int L, int V, typename M>
__device__ __forceinline__ void fwd_row(const M& mask, int i,
                                        const FwdArgs& a, float* base) {
  constexpr int NB = rows_of(V);
  const Row<L> row;
  const float* __restrict__ s = a.s;
  const float* __restrict__ h = a.h;
  const int H = a.H, C = a.C, HC = H * C;
  const Lanes lanes = a.lanes;
  const uint32_t thresh = a.thresh;
  const float scale = a.scale, slope = a.slope;
  const size_t irow = static_cast<size_t>(i);
  const int chunk = chunk_of(H, L);
  int* cols = reinterpret_cast<int*>(base);
  float* wgt = base + chunk;       // (chunk, H): logits, then weights
  float* m_h = wgt + chunk * H;    // the row's maximum so far, per head
  float* l_h = m_h + H;            // its denominator, relative to it
  float* f_h = l_h + H;            // a chunk's rescaling of the sums
  const uint32_t seed = static_cast<uint32_t>(__ldg(a.seed));
  // H divides L: lane t keeps to head t % H, and its pairs are the
  // entries t / H, t / H + L / H, ... of a chunk
  const bool lane_head = L % H == 0;
  const int hd0 = row.lane % H;
  const int e_first = row.lane / H;
  const int e_step = L / H;
  const uint32_t salt0 = hash_salt(seed, hd0);
  const float di = __ldg(a.d + irow * H + hd0);
  const int q = row.lane % lanes.le;
  const int r0 = row.lane / lanes.le;
  const int R = L / lanes.le;

  for (int c0 = 0; c0 < HC; c0 += lanes.win) {
    // this lane's V channels from c (-1: none) and their head
    const int c = c0 + q * V < HC ? c0 + q * V : -1;
    const int hc = c >= 0 ? c / C : 0;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    float m_run = -INFINITY, l_run = 0.f;   // head hd0's, where lane_head
    if (!lane_head) {
      for (int hd = row.lane; hd < H; hd += L) {
        m_h[hd] = -INFINITY;
        l_h[hd] = 0.f;
      }
    }
    Cursor cur = cursor_of(mask, i);
    for (;;) {
      const int ne = decode_chunk<L>(mask, cur, cols, chunk, row);
      if (ne == 0) break;
      // this lane's first sender rows, loaded beside the logits' inputs
      float x[NB][V];
      load_rows<NB, V>(x, h, cols, r0, R, ne, HC, c);
      if (lane_head) {
        float zmax = -INFINITY;
        for (int e0 = e_first; e0 < ne; e0 += e_step * kLoads) {
          float sv[kLoads];
#pragma unroll
          for (int b = 0; b < kLoads; ++b) {
            const int e = e0 + b * e_step;
            sv[b] = e < ne
                        ? __ldg(s + static_cast<size_t>(cols[e]) * H + hd0)
                        : 0.f;
          }
#pragma unroll
          for (int b = 0; b < kLoads; ++b) {
            const int e = e0 + b * e_step;
            if (e < ne) {
              const float z = leaky(di + sv[b], slope);
              wgt[e * H + hd0] = z;
              zmax = fmaxf(zmax, z);
            }
          }
        }
        const float m_new = fmaxf(m_run, row.max_from(zmax, H));
        const float f = expf(m_run - m_new);   // 0 on the first chunk
        float lsum = 0.f;
        for (int e = e_first; e < ne; e += e_step) {
          const float pz = expf(wgt[e * H + hd0] - m_new);
          lsum += pz;
          wgt[e * H + hd0] =
              keep_scale(salt0, i, cols[e], thresh, 1.f) != 0.f ? pz : 0.f;
        }
        l_run = l_run * f + row.sum_from(lsum, H);
        m_run = m_new;
        if (row.lane < H) f_h[row.lane] = f;
      } else {
        const int pairs = ne * H;
        for (int p0 = row.lane; p0 < pairs; p0 += L * kLoads) {
          float sv[kLoads], dv[kLoads];
#pragma unroll
          for (int b = 0; b < kLoads; ++b) {
            const int p = p0 + b * L;
            sv[b] = dv[b] = 0.f;
            if (p < pairs) {
              const int e = p / H;
              const int hd = p - e * H;
              sv[b] = __ldg(s + static_cast<size_t>(cols[e]) * H + hd);
              dv[b] = __ldg(a.d + irow * H + hd);
            }
          }
#pragma unroll
          for (int b = 0; b < kLoads; ++b) {
            const int p = p0 + b * L;
            if (p < pairs) wgt[p] = leaky(dv[b] + sv[b], slope);
          }
        }
        row.sync();
        for (int hd = row.lane; hd < H; hd += L) {
          float cmax = -INFINITY;
          for (int e = 0; e < ne; ++e) cmax = fmaxf(cmax, wgt[e * H + hd]);
          const float m_new = fmaxf(m_h[hd], cmax);
          const float f = expf(m_h[hd] - m_new);
          const uint32_t salt = hash_salt(seed, hd);
          float lsum = 0.f;
          for (int e = 0; e < ne; ++e) {
            const float pz = expf(wgt[e * H + hd] - m_new);
            lsum += pz;
            wgt[e * H + hd] =
                keep_scale(salt, i, cols[e], thresh, 1.f) != 0.f ? pz : 0.f;
          }
          l_h[hd] = l_h[hd] * f + lsum;
          m_h[hd] = m_new;
          f_h[hd] = f;
        }
      }
      row.sync();
      // the chunk's sums, NB entries a lane with their rows' loads issued
      // together; then the sums so far, to the new maximum, plus them
      float part[V];
#pragma unroll
      for (int v = 0; v < V; ++v) part[v] = 0.f;
      for (int e0 = r0; e0 < ne; e0 += R * NB) {
        if (e0 != r0) load_rows<NB, V>(x, h, cols, e0, R, ne, HC, c);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int e = e0 + b * R;
          if (e >= ne) continue;
          const float w = wgt[e * H + hc];
#pragma unroll
          for (int v = 0; v < V; ++v) part[v] += w * x[b][v];
        }
      }
      const float f = f_h[hc];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = acc[v] * f + part[v];
      if (ne < chunk) break;
    }
    // the entry groups' sums meet; each head's denominator divides them
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = row.sum_from(acc[v], lanes.le);
    if (lane_head && row.lane < H) {
      m_h[row.lane] = m_run;
      l_h[row.lane] = l_run;
    }
    row.sync();
    if (r0 == 0 && c >= 0) {
      const float factor = scale / fmaxf(l_h[hc], 1e-20f);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] *= factor;
      store_vec<V>(a.out + irow * HC + c, acc);
    }
    if (c0 == 0) {
      for (int hd = row.lane; hd < H; hd += L) {
        const float m = m_h[hd];
        a.lse[irow * H + hd] =
            (m > -INFINITY ? m : 0.f) + logf(fmaxf(l_h[hd], 1e-20f));
      }
    }
    row.sync();
  }
}

// Forward: the lanes of a sub-warp over row i of the mask, all heads.
template <int L, int V>
__global__ void __launch_bounds__(kThreads, 4)
bsr_fwd_kernel(Strips mask, FwdArgs a) {
  extern __shared__ float smem[];
  const int sub = threadIdx.x / L;
  const int i = blockIdx.x * (blockDim.x / L) + sub;
  if (i < a.n) fwd_row<L, V>(mask, i, a, smem + sub * fwd_floats(a.H, L));
}

// Sender rows a lane of the row pass loads before it uses any of them.
constexpr int kRowRows = 2;

// Backward, row pass where H > 1 divides the row's lanes and C <= KC (the
// main path's conv1): the L lanes of a sub-warp over row i of the mask,
// all heads; writes dd and D. Lane t keeps to head t % H and takes the
// entries t / H, t / H + L / H, ... of each chunk, so each (entry, head)
// pair is one lane's: it holds the head's channels of g[i] in registers,
// forms D, loads d[i], lse[i] and the salt once per row, and per entry
// gathers the head's slice of the h[j] row (whole 16-byte loads) and
// s[j] and forms the dot, exp, hash and dz once, with no shuffle. D is
// formed in a group's order and the dot channel after channel, as the
// dense-mask kernels form them (gat_mask.cuh), so that the two agree
// entry for entry. Only the column list goes through shared memory; the
// entry groups' sums meet in a fixed tree.
template <int L, int V, int KC>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_row_kernel(Strips mask, const float* __restrict__ d,
                   const float* __restrict__ s, const float* __restrict__ h,
                   const float* __restrict__ lse,
                   const float* __restrict__ out,
                   const float* __restrict__ g,
                   const int* __restrict__ seed_ptr, float* __restrict__ dd,
                   float* __restrict__ D, int n, int H, int C,
                   uint32_t thresh, float scale, float slope) {
  constexpr int NB = kRowRows;
  extern __shared__ float smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int i = blockIdx.x * (blockDim.x / L) + sub;
  if (i >= n) return;
  const int HC = H * C;
  const size_t irow = static_cast<size_t>(i);
  const int chunk = chunk_of(H, L);
  int* cols = reinterpret_cast<int*>(smem) + sub * chunk;   // senders j
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
  Cursor cur = cursor_of(mask, i);
  for (;;) {
    const int ne = decode_chunk<L>(mask, cur, cols, chunk, row);
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

// The first design's walk, which the row pass keeps at some widths. Calls
// body(c) for every entry (i, c) of row i: the row's words in the blocks
// of its strip (wj per block), each lane of the group on the words lane,
// lane + kGroup, ..., of which it loads kBatch, and their blocks'
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

// Backward, row pass, the first design: group (i, hd) over row i of the
// mask; writes dd and D = <g[i], out[i]> of the head. Kept where
// bsr_bwd_row_kernel does not apply (one head, or lanes.cv == 0).
template <int KC>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_row_heads_kernel(Strips mask, const float* __restrict__ d,
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

// Backward, column pass where the channels of each head lie on cv
// neighbouring lanes and one pass covers the row (lanes.cv > 0, the main
// path's widths): the lanes of a sub-warp over row j of the transposed
// mask (an entry i of that row: the mask's entry (i, j)), all heads;
// writes ds and dh. One gathered g[i] row serves both the dot <g[i],
// h[j]> of each head (a sum over its cv lanes) and dh[j] += beta g[i];
// each lane forms its head's alpha, keep and beta itself from d, lse and
// D of (i, head), loaded beside the row, so nothing but the column list
// goes through shared memory.
template <int L, int V>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_col_kernel(Strips mask_t, const float* __restrict__ d,
                   const float* __restrict__ s, const float* __restrict__ h,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, const float* __restrict__ g,
                   const int* __restrict__ seed_ptr, float* __restrict__ ds,
                   float* __restrict__ dh, int n, int H, int C, Lanes lanes,
                   uint32_t thresh, float scale, float slope) {
  constexpr int NB = rows_of(V);
  extern __shared__ float smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int j = blockIdx.x * (blockDim.x / L) + sub;
  if (j >= n) return;
  const int HC = H * C;
  const size_t jrow = static_cast<size_t>(j);
  const int chunk = chunk_of(H, L);
  int* cols = reinterpret_cast<int*>(smem) + sub * chunk;   // receivers i
  const int q = row.lane % lanes.le;
  const int r0 = row.lane / lanes.le;
  const int R = L / lanes.le;
  const int cv = lanes.cv;
  const bool owner = q % cv == 0;   // the lane that counts its head's ds
  // this lane's V channels from c (-1: none), their head and its terms
  const int c = q * V < HC ? q * V : -1;
  const int hc = c >= 0 ? c / C : 0;
  float hj[V];
  if (c >= 0) {
    load_vec<V>(h + jrow * HC + c, hj);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) hj[v] = 0.f;
  }
  const float sj = __ldg(s + jrow * H + hc);
  const uint32_t salt = hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hc);
  float acc[V], ds_acc = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  Cursor cur = cursor_of(mask_t, j);
  for (;;) {
    const int ne = decode_chunk<L>(mask_t, cur, cols, chunk, row);
    if (ne == 0) break;
    // the chunk's sums, NB entries a lane at once with every load of them
    // issued together
    float part[V], ds_part = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) part[v] = 0.f;
    for (int e0 = r0; e0 - r0 < ne; e0 += R * NB) {
      float gv[NB][V], dv[NB], lv[NB], Dv[NB];
      load_rows<NB, V>(gv, g, cols, e0, R, ne, HC, c);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        dv[b] = lv[b] = Dv[b] = 0.f;
        if (e < ne && c >= 0) {
          const size_t ih = static_cast<size_t>(cols[e]) * H + hc;
          dv[b] = __ldg(d + ih);
          lv[b] = __ldg(lse + ih);
          Dv[b] = __ldg(D + ih);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) dot += gv[b][v] * hj[v];
        dot = row.sum_below(dot, cv);
        if (e < ne && c >= 0) {
          const float zpre = dv[b] + sj;
          const float alpha = expf(leaky(zpre, slope) - lv[b]);
          const float ks = keep_scale(salt, cols[e], j, thresh, scale);
          const float beta = alpha * ks;
#pragma unroll
          for (int v = 0; v < V; ++v) part[v] += beta * gv[b][v];
          if (owner) {
            const float dz = alpha * (ks * dot - Dv[b]);
            ds_part += zpre > 0.f ? dz : slope * dz;
          }
        }
      }
    }
    ds_acc += ds_part;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += part[v];
    if (ne < chunk) break;
  }
  // the entry groups' sums meet
  ds_acc = row.sum_from(ds_acc, lanes.le);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = row.sum_from(acc[v], lanes.le);
  if (r0 == 0 && c >= 0) {
    store_vec<V>(dh + jrow * HC + c, acc);
    if (owner) ds[jrow * H + hc] = ds_acc;
  }
}

// Backward, column pass at the other widths (lanes.cv == 0), in several
// passes of channels where the row is wider than its lanes: as
// bsr_bwd_col_kernel, but the (entry, head) terms are formed first, one
// pair a lane (the dot <g[i], h[j]> from memory, in the first pass), and
// kept in shared memory for the gather of g[i] rows.
template <int L, int V>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_col_pairs_kernel(Strips mask_t, const float* __restrict__ d,
                         const float* __restrict__ s,
                         const float* __restrict__ h,
                         const float* __restrict__ lse,
                         const float* __restrict__ D,
                         const float* __restrict__ g,
                         const int* __restrict__ seed_ptr,
                         float* __restrict__ ds, float* __restrict__ dh,
                         int n, int H, int C, Lanes lanes, uint32_t thresh,
                         float scale, float slope) {
  constexpr int NB = rows_of(V);
  extern __shared__ float smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int j = blockIdx.x * (blockDim.x / L) + sub;
  if (j >= n) return;
  const int HC = H * C;
  const size_t jrow = static_cast<size_t>(j);
  const int chunk = chunk_of(H, L);
  float* base = smem + sub * col_pairs_floats(H, L);
  int* cols = reinterpret_cast<int*>(base);   // the receivers i
  float* beta = base + chunk;    // (chunk, H): alpha keep scale
  float* dz = beta + chunk * H;  // (chunk, H): dz
  float* ds_h = dz + chunk * H;  // (H): ds so far, where H does not divide L
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  // H divides L: lane t keeps to head t % H (see bsr_fwd_kernel)
  const bool lane_head = L % H == 0;
  const int hd0 = row.lane % H;
  const int e_first = row.lane / H;
  const int e_step = L / H;
  const float sj0 = __ldg(s + jrow * H + hd0);
  const uint32_t salt0 = hash_salt(seed, hd0);
  const int q = row.lane % lanes.le;
  const int r0 = row.lane / lanes.le;
  const int R = L / lanes.le;

  for (int c0 = 0; c0 < HC; c0 += lanes.win) {
    const bool first = c0 == 0;   // the pass that forms dz and ds
    const int c = c0 + q * V < HC ? c0 + q * V : -1;
    const int hc = c >= 0 ? c / C : 0;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    float ds_run = 0.f;   // lane_head: head hd0's share
    if (!lane_head && first) {
      for (int hd = row.lane; hd < H; hd += L) ds_h[hd] = 0.f;
    }
    Cursor cur = cursor_of(mask_t, j);
    for (;;) {
      const int ne = decode_chunk<L>(mask_t, cur, cols, chunk, row);
      if (ne == 0) break;
      // this lane's first g[i] rows, loaded beside the terms' inputs
      float gv[NB][V];
      load_rows<NB, V>(gv, g, cols, r0, R, ne, HC, c);
      // the per-(entry, head) terms, kLoads pairs a lane with their loads
      // issued together
      const int p_first = lane_head ? e_first : row.lane;
      const int p_step = lane_head ? e_step : L;   // in entries, or pairs
      const int p_end = lane_head ? ne : ne * H;
      for (int p0 = p_first; p0 < p_end; p0 += p_step * kLoads) {
        float dv[kLoads], lv[kLoads], Dv[kLoads];
#pragma unroll
        for (int b = 0; b < kLoads; ++b) {
          const int t = p0 + b * p_step;
          dv[b] = lv[b] = Dv[b] = 0.f;
          if (t < p_end) {
            const int e = lane_head ? t : t / H;
            const int hd = lane_head ? hd0 : t - e * H;
            const size_t ih = static_cast<size_t>(cols[e]) * H + hd;
            dv[b] = __ldg(d + ih);
            lv[b] = __ldg(lse + ih);
            if (first) Dv[b] = __ldg(D + ih);
          }
        }
#pragma unroll
        for (int b = 0; b < kLoads; ++b) {
          const int t = p0 + b * p_step;
          if (t >= p_end) continue;
          const int e = lane_head ? t : t / H;
          const int hd = lane_head ? hd0 : t - e * H;
          const int p = e * H + hd;
          const int i = cols[e];
          const float zpre =
              dv[b] + (lane_head ? sj0 : __ldg(s + jrow * H + hd));
          const float alpha = expf(leaky(zpre, slope) - lv[b]);
          const float ks = keep_scale(lane_head ? salt0 : hash_salt(seed, hd),
                                      i, j, thresh, scale);
          beta[p] = alpha * ks;
          if (first) {
            const float dot =
                dot_from_memory(g + static_cast<size_t>(i) * HC + hd * C,
                                h + jrow * HC + hd * C, C);
            const float dzp = alpha * (ks * dot - Dv[b]);
            dz[p] = zpre > 0.f ? dzp : slope * dzp;
          }
        }
      }
      row.sync();
      // g[i] rows, whole, NB entries a lane at once: dh
      float part[V];
#pragma unroll
      for (int v = 0; v < V; ++v) part[v] = 0.f;
      for (int e0 = r0; e0 < ne; e0 += R * NB) {
        if (e0 != r0) load_rows<NB, V>(gv, g, cols, e0, R, ne, HC, c);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int e = e0 + b * R;
          if (e >= ne) continue;
          const float w = beta[e * H + hc];
#pragma unroll
          for (int v = 0; v < V; ++v) part[v] += w * gv[b][v];
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += part[v];
      if (first) {
        if (lane_head) {
          float sum = 0.f;
          for (int e = e_first; e < ne; e += e_step) sum += dz[e * H + hd0];
          ds_run += sum;
        } else {
          for (int hd = row.lane; hd < H; hd += L) {
            float sum = 0.f;
            for (int e = 0; e < ne; ++e) sum += dz[e * H + hd];
            ds_h[hd] += sum;
          }
        }
      }
      if (ne < chunk) break;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = row.sum_from(acc[v], lanes.le);
    if (r0 == 0 && c >= 0) store_vec<V>(dh + jrow * HC + c, acc);
    if (first) {
      if (lane_head) {
        ds_run = row.sum_from(ds_run, H);
        if (row.lane < H) ds[jrow * H + row.lane] = ds_run;
      } else {
        for (int hd = row.lane; hd < H; hd += L) ds[jrow * H + hd] = ds_h[hd];
      }
    }
    row.sync();
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Lanes a row of n: the fewest of 4, 8, 16 and 32 that hold the H C
// channels at V a lane, and at least H where H <= 32 (so that a lane keeps
// to one head); twice that where the n rows at that width fill less than
// one wave of the card: such a launch is bound by its longest row's chain
// of loads, which twice the lanes (twice the entries a pass) shortens.
int lanes_per_row(int H, int C, int V, int n) {
  int L = 4;
  while (L < 32 && (L * V < H * C || L < H)) L *= 2;
  if (L < 32 && static_cast<long long>(n) * L < wave_threads()) L *= 2;
  return L;
}

// The lane map of a row of H C channels on L lanes, V channels a load.
template <int L, int V>
Lanes lanes_of(int H, int C) {
  const int HC = H * C;
  const int slots = (HC + V - 1) / V;
  Lanes ln;
  ln.le = L < pow2_at_least(slots) ? L : pow2_at_least(slots);
  ln.win = ln.le * V;
  const int cv = C / V;
  ln.cv = cv == pow2_at_least(cv) && cv <= ln.le && ln.win >= HC ? cv : 0;
  // one head: the dot is a sum over all le lanes
  if (H == 1 && ln.win >= HC) ln.cv = ln.le;
  return ln;
}

// Calls f(L, V) as integral constants: V channels a lane
// (channels_per_lane), L lanes a row (lanes_per_row).
template <typename Fn>
void with_lanes(int H, int C, int n, bool aligned, Fn&& f) {
  const int V = channels_per_lane(C, aligned);
  with_row_lanes(lanes_per_row(H, C, V, n), V, f);
}

// Launches kernel over n rows of L lanes each, kThreads / L rows a block
// (fewer where their shared memory, `floats` floats a row, would exceed
// what a block may have), opting in above the default 48 KB.
template <int L, typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int n, int floats, cudaStream_t stream,
                Args... args) {
  constexpr size_t kDefault = 48 * 1024, kMax = 227 * 1024;
  const size_t per_row = static_cast<size_t>(floats) * sizeof(float);
  size_t rows = kThreads / L;
  if (rows * per_row > kMax) rows = per_row < kMax ? kMax / per_row : 1;
  const size_t bytes = rows * per_row;
  if (bytes > kDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int grid = static_cast<int>((n + rows - 1) / rows);
  kernel<<<grid, static_cast<int>(rows) * L, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launches the first design of the row pass (bsr_bwd_row_heads_kernel)
// over n rows, bsr_gat_bwd_row's arguments; the CUDA error.
int launch_row_heads(const Strips& mask, void* d, void* s, void* h,
                     void* lse, void* out, void* g, void* seed, void* dd,
                     void* D, int n, int H, int C, uint32_t thresh,
                     float scale, float slope, cudaStream_t stream) {
  with_channel_chunk(C, [&](auto chunk) {
    constexpr int KC = decltype(chunk)::value;
    bsr_bwd_row_heads_kernel<KC><<<blocks_for(n, H), kThreads, 0, stream>>>(
        mask, static_cast<const float*>(d), static_cast<const float*>(s),
        static_cast<const float*>(h), static_cast<const float*>(lse),
        static_cast<const float*>(out), static_cast<const float*>(g),
        static_cast<const int*>(seed), static_cast<float*>(dd),
        static_cast<float*>(D), n, H, C, thresh, scale, slope);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: out (n, H*C) and lse (n, H) from the mask's blocks.
extern "C" int bsr_gat_fwd(void* strip_ptr, void* block_col, void* words,
                           void* d, void* s, void* h, void* seed, void* out,
                           void* lse, int n, int ti, int wj, int H, int C,
                           unsigned thresh, float scale, float slope,
                           void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    int rc = 0;
    const bool aligned = aligned16(h) && aligned16(out);
    with_lanes(H, C, n, aligned, [&](auto lanes, auto vec) {
      constexpr int L = decltype(lanes)::value;
      constexpr int V = decltype(vec)::value;
      rc = launch_rows<L>(
          bsr_fwd_kernel<L, V>, n, fwd_floats(H, L),
          static_cast<cudaStream_t>(stream),
          strips_of(strip_ptr, block_col, words, ti, wj),
          FwdArgs{static_cast<const float*>(d), static_cast<const float*>(s),
                  static_cast<const float*>(h), static_cast<const int*>(seed),
                  static_cast<float*>(out), static_cast<float*>(lse), n, H,
                  C, lanes_of<L, V>(H, C), thresh, scale, slope});
    });
    return rc;
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
    const Strips mask = strips_of(strip_ptr, block_col, words, ti, wj);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc = -1;
    const bool aligned = aligned16(h) && aligned16(g) && aligned16(out);
    with_lanes(H, C, n, aligned, [&](auto lanes, auto vec) {
      constexpr int L = decltype(lanes)::value;
      constexpr int V = decltype(vec)::value;
      // the first design's widths: one head, a head count that does not
      // divide the lanes, or heads wider than 32 channels
      if (H == 1 || L % H != 0 || C > 32) return;
      with_channel_chunk(C, [&](auto chunk) {
        constexpr int KC = decltype(chunk)::value;
        rc = launch_rows<L>(
            bsr_bwd_row_kernel<L, V, KC>, n, chunk_of(H, L), st, mask,
            static_cast<const float*>(d), static_cast<const float*>(s),
            static_cast<const float*>(h), static_cast<const float*>(lse),
            static_cast<const float*>(out), static_cast<const float*>(g),
            static_cast<const int*>(seed), static_cast<float*>(dd),
            static_cast<float*>(D), n, H, C, thresh, scale, slope);
      });
    });
    return rc >= 0 ? rc : launch_row_heads(mask, d, s, h, lse, out, g, seed,
                                           dd, D, n, H, C, thresh, scale,
                                           slope, st);
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
    int rc = 0;
    const bool aligned = aligned16(h) && aligned16(g) && aligned16(dh);
    with_lanes(H, C, n, aligned, [&](auto lanes, auto vec) {
      constexpr int L = decltype(lanes)::value;
      constexpr int V = decltype(vec)::value;
      const Lanes ln = lanes_of<L, V>(H, C);
      const bool fused = ln.cv > 0;
      rc = launch_rows<L>(
          fused ? bsr_bwd_col_kernel<L, V> : bsr_bwd_col_pairs_kernel<L, V>,
          n, fused ? chunk_of(H, L) : col_pairs_floats(H, L),
          static_cast<cudaStream_t>(stream),
          strips_of(strip_ptr_t, block_col_t, words_t, ti, wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const float*>(lse),
          static_cast<const float*>(D), static_cast<const float*>(g),
          static_cast<const int*>(seed), static_cast<float*>(ds),
          static_cast<float*>(dh), n, H, C, ln, thresh, scale, slope);
    });
    return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

// Entries of one column-list chunk of the forward and the column pass at
// (H, C) over n rows, for 16-byte aligned rows.
extern "C" int bsr_gat_chunk(int H, int C, int n) {
  return chunk_of(H, lanes_per_row(H, C, channels_per_lane(C, true), n));
}
