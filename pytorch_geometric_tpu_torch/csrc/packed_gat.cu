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
//   shift = leaky(m[dst] + d[dst])      m[dst] = max of s over dst's
//                                       senders (0 for a row without edges)
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
// The shift is the receiver's largest incoming logit (leaky is monotone),
// so every row that has an edge has one exp of 1 and a den of at least 1:
// no receiver underflows, however far its logits sit below another
// row's. (The TPU kernel shifts by one max of s a head over all rows, and
// a receiver whose best logit sits ~87 below it underflows to 0.) The
// forward finds m in a walk of its own over the row's senders before the
// walk that sums, and writes it out, (n_rows, H); the backward reads it:
// walk 0 once a row, walk 1 gathered per edge beside d[dst].
//
// What bounds it: bytes, in principle. A call reads the CSR (4 B per edge
// and row, and 4 B per edge of edge ids on the sender side), s and d
// (4 B * H per node), h (4 B * H * C per node) and, backward, g (4 B *
// (H*C + H) per node) and m (4 B * H); it writes 4 B * (H*C + H) per node
// and, forward, m. It does about 2 flops per edge and channel forward (4
// backward), far below the card's rate for so few bytes. At Cora's conv1
// shapes (3072 rows, about 13.6k edges, H = 8, C = 8) that is about 2 MB,
// under a microsecond at 3.35 TB/s. In practice a row is a chain of
// dependent loads (row_ptr -> col -> the neighbour's row -> the store),
// each step an L2 round trip, and the walk is bound by that chain and by
// the instructions of each edge.
//
// Three lane maps, by width (packed_gat_fwd and packed_gat_bwd dispatch):
// the row map for heads of at most 32 channels, the wide-head map past
// them, and the backward's first design at the narrow widths the row map
// leaves ((3, 5)).
//
// The first design (gat_bwd_heads_kernel; its forward, gat_fwd_kernel,
// which the library launches at no width since the wide-head map, is kept
// in probes/packed_gat_designs.cu): a group of G lanes (G = 4, 8, 16 or
// 32: with_group_width) owns one (row, head) pair; lane l keeps the
// channels l, l + G, ... of a chunk of G * kVec channels, and every lane of
// the group computes the same per-edge scalars (logit, exp, keep bit) with
// the same instructions, walking the row's edges one after another, so a
// row of deg edges is deg steps of the chain deep, col[e] is loaded H
// times, and a head of more than G kVec = 128 channels walks its row once
// a chunk. The backward's per-head dot <gnum, h> is a butterfly of
// shuffles within the group, an edge at a time.
//
// The row map of the backward (gat_bwd_kernel), after the block-sparse
// GAT's row pass (bsr_gat.cu), and of the forward (gat_fwd_rows_kernel,
// which is the backward's walk 0 with the forward's terms):
// - The L lanes of a sub-warp own one CSR row over all H heads (L from
//   packed_lanes: the fewest of 4, 8, 16, 32 that hold the row's H C
//   channels at V a lane, twice that where the launch fills less than
//   one wave of the card). Lane t keeps to head t % H and takes the
//   edges t / H, t / H + L / H, ... of the row, kEdgeLoads of them with
//   every load issued together, so a row of up to L / H * kEdgeLoads
//   edges (8 at Cora's conv1) is one step of the chain deep, not deg
//   steps; col[e] (and eid[e] in walk 1) is loaded once per edge for all
//   heads (the lanes of an entry group read one address), where a group
//   per (row, head) loaded it H times.
// - Each (edge, head) pair is one lane's: it gathers the head's slice of
//   the neighbour's row (walk 0 h[src], walk 1 gnum[dst]) as whole
//   16-byte loads where C is a multiple of 4 and the rows are aligned
//   (row_lanes.cuh: load_head), so an entry group's lanes read the row
//   whole; it forms the dot in its registers, without a shuffle, and the
//   logit, exp and hash once. In walk 1 the one gathered gnum[dst] row
//   serves both the dot and dh[src] += gnum ex ks. The row's own terms
//   are loaded once, before the walk: walk 0 d, m, gnum and gden of the
//   receiver; walk 1 s and h of the sender (its edges gather d and m of
//   their receivers).
// - The forward's lane gathers the head's slice of h[src] whole, loads
//   s[src], forms the logit, the expf and the keep hash (edge id = CSR
//   position) once, and adds w h into its num registers and ex into den;
//   the row's d is loaded once, and its m found by the lanes' walk over
//   the senders' s before the walk that sums (the entry groups' maxima
//   meet in group 0 and go back to every lane of the head). The entry
//   groups' num and den meet in the fixed tree below; the lanes of entry
//   group 0 store the row's num (whole 16-byte stores where the out row
//   of H C + H floats and the pointers allow) and den. Its lanes come
//   from fwd_lanes: the fewest that hold the channels, doubled only where
//   a step of the walk at the fewest takes fewer than 8 edges (and the
//   launch fills less than one wave), since the extra lanes add threads
//   and a level of the tree to every row.
// - The backward's map runs where the heads divide the lanes and a head
//   has at most 32 channels (registers for them: 8 or 32); of the other
//   widths, a head of more than 32 channels takes the wide-head map below
//   and the rest ((3, 5)) the first design. The forward's runs wherever a
//   row's lanes hold its heads and a head has at most 32 channels (else
//   the wide-head map): where the heads do not divide the lanes
//   ((3, 5): 5 entry groups of 3 lanes in 16), the lanes past the last
//   whole group walk no edge, and the groups' sums meet in a tree of
//   shuffles down by multiples of H (row_lanes.cuh: Row::sum_groups).
//
// The wide-head map (gat_fwd_wide_kernel, gat_bwd_wide_kernel), after the
// CSR SpMM's chunk map (spmm_csr.cu), for heads of more than 32 channels
// (PPI's (4, 256) and (6, 121), the research driver's (8, 135) and
// (8, 102)):
// - A warp owns one (row, head) pair, its lanes across the head's
//   channels: lane t keeps channels (k 32 + t) V + v, k < K, so each
//   gather of the warp reads 32 V consecutive channels of the neighbour's
//   head (128 bytes at V = 1, where a head's slice is not 16-byte aligned:
//   PPI's (6, 121) at 484 bytes a head, the driver's 540 and 408; 512 at
//   V = 4, float4 loads where C is a multiple of 4 and the rows aligned:
//   (4, 256)). K = ceil(C / 32 V), so every head up to 256 channels is one
//   pass over its row (the first design walked (4, 256)'s and (8, 135)'s
//   rows twice, the second pass of (8, 135) with 7 channels live); a
//   wider head takes passes of 256.
// - The row's edges go 32 at a time, one a lane: each lane loads its
//   edge's col[e] (and eid[e] in walk 1) and forms that (edge, head)'s
//   terms once (the forward: s[src], the logit, expf and the keep hash;
//   walk 0: s[src]; walk 1: d, m and gden of the receiver), where every
//   lane of the first design's group formed every edge's. The walk hands
//   them round by shuffles and issues the gathers of NB edges together
//   (NB V K = 8 channels a lane in flight, one edge where V K is 8 or
//   more: probes/chunk_map_variants.py found 8 better than 16 or 32 on
//   the chunk map). A PPI row (~22 edges) is then one step of the index
//   chain, not ~22.
// - The forward's shift walk loads each sender and its s once, a lane an
//   edge, and keeps the first 32 for the walk that sums; m is the warp's
//   max.
// - The backward's per-edge dot enters dz linearly, so a row's sum of it
//   is taken channel by channel before any reduction: each lane keeps
//   t[c] = sum_e sf_e ex_e ks_e x_e[c] (sf_e = 1 or the slope, by the sign
//   of the edge's pre-activation; x_e the gathered head, h[src] in walk 0
//   and gnum[dst] in walk 1), and dd (ds) = sum_c own[c] t[c] +
//   sum_e sf_e ex_e gden is one 5-level sum over the warp a row, where the
//   first design reduced a butterfly an edge, in series with the walk. In
//   walk 1 the one gathered gnum[dst] slice serves t and dh; walk 0 keeps
//   the receiver's gnum slice in registers and gathers h[src].
// - What bounds it: the gathers' L2 traffic. Each gathering walk moves
//   E H C 4 bytes through L2 (bounds.py: gat_gather_bytes), the forward
//   one walk and the backward two, where the byte bound counts each node
//   row once: at a PPI train graph (68,474 edges) and (4, 256) 280 MB a
//   walk against a byte bound of 7.7 us for the forward. The chunk map
//   moved such gathers at ~4.9 TB/s (spmm_csr.cu, Cora F = 1433); this
//   map moves PPI's at 4.3-6.6 TB/s (the times below), where the first
//   design moved them at 1.5-4.9.
// - Each output element is written by one lane. Every channel of num and
//   dh, and den, is summed over the row's edges in CSR order from 0 in one
//   fp32 accumulator, as the first design sums them, so num, den, m and dh
//   are bitwise the first design's; dd and ds (whose dot and sums are
//   taken in another tree) agree with it to rounding (within 1e-6 of the
//   largest magnitude in the card tests).
//
// Every map:
// - No atomics. Walk 0 walks the receiver-major CSR (edge id = CSR
//   position) and writes dd; walk 1 walks the sender-major CSR (edge id
//   from its permutation) and writes ds and dh. Every sum over lanes is a
//   fixed tree of shuffles, so two launches are bitwise equal; rows with
//   no edges are written as 0, so outputs may come from torch.empty. A
//   launch depends on the shapes and the pointers' alignment only and
//   allocates nothing, so it captures in a CUDA graph.
// - The dropout seed is read from device memory, so the caller never
//   waits on the card for it; m is the forward's own output.
// - fp32 throughout; expf (not __expf) and no fast-math flags, so the
//   kernel holds 1e-5 against the plain PyTorch version.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, warm device us per call
// (both walks), first design -> this one, both timed in one run by
// probes/packed_gat_designs.py (PERF.md): Cora conv1 (3072 rows, 13.6k
// edges, H = C = 8, dropout 0.6) 24.8 -> 7.6 (bound 0.9), conv2 (1, 7)
// 16.0 -> 8.0; PubMed after RCM (24,576 rows, 113k edges) (8, 8) 108.0
// -> 23.1, (1, 3) 19.1 -> 15.9; a graph with a receiver of 500 senders
// and a sender of 400 receivers (8, 8) 446 -> 65, (1, 7) 328 -> 23.
// clock64 marks (probes/packed_gat_variants.py) put a step of the edge
// loop at 1,000-3,700 cycles: the col[e] load and then the gathers it
// feeds, two dependent round trips. The forward, first design -> row map,
// in one run of the same probe: Cora conv1 (dropout 0.6) 6.7 -> 3.8
// (bound 0.6), conv2 (1, 7) 5.9 -> 4.5; RCM-PubMed (8, 8) 29.0 -> 10.5,
// (1, 3) 6.7 -> 5.6; the hub graph (8, 8) 152 -> 36, (1, 7) 87 -> 20,
// (3, 5) 131 -> 31.
// The wide-head map, first design -> wide-head map, warm, in one run of the
// same probe (NVIDIA H100 80GB HBM3, 700.00 W; the L2 gather rate in
// brackets): PPI's first train graph (3,072 rows, 68,474 edges, ~22 a
// row) forward (4, 256) 65.0 -> 52.3 [5.4 TB/s], (6, 121) 49.3 -> 43.4
// [4.6], backward 196.0 -> 93.0 [6.0] and 255.0 -> 93.1 [4.3]; its val
// batch (6,144 rows, 141,416 edges) forward 119.3 -> 92.5 and 90.6 ->
// 81.7, backward 343.0 -> 176.5 and 476.2 -> 182.7; the research driver's
// Cora edge set (13,560 edges, ~4.4 a row) forward (8, 135) 29.9 -> 26.2,
// (8, 102) 18.0 -> 18.3, backward 84.3 -> 45.9 and 77.6 -> 43.8: on rows
// that short the row's chain of loads, not the gathers, sets the time.
// The map is slower than the row map wherever that runs (Cora (8, 8)
// backward 32.7 against 7.4) and at narrow heads on many short rows
// (RCM-PubMed (1, 3) 33.3 against the first design's 18.4), so the
// backward keeps its first design at the narrow widths the row map
// leaves, though the map beat it on the hub graph at (3, 5) (117.4
// against 416.2).
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
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
// Edges a lane of gat_bwd_kernel loads before it uses any of them.
constexpr int kEdgeLoads = 2;

// Terms of the backward that an ablation removes, one bit each. Walk 0
// gathers h and s, walk 1 gnum, gden and d: kNoGatherH removes nothing
// from walk 1 and kNoGatherG nothing from walk 0, whose own rows are
// loaded once anyway. The dot is one lane's, without a shuffle, so
// kNoShuffle removes the shuffles that merge the entry groups' sums.
namespace gat_ablate {
constexpr unsigned kNoIndex = 1u << 0;    // other = r: no load of col[e]
constexpr unsigned kNoGatherS = 1u << 1;  // neighbour's s, or d and m: own
constexpr unsigned kNoGatherG = 1u << 2;  // gnum, gden: loaded once per row
constexpr unsigned kNoGatherH = 1u << 3;  // h[send] of the dot: once per row
constexpr unsigned kNoExp = 1u << 4;      // no expf
constexpr unsigned kNoDrop = 1u << 5;     // no dropout hash
constexpr unsigned kNoShuffle = 1u << 6;  // no shuffles (see the kernel)
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

// The forward's arguments beside the lane map.
struct FwdArgs {
  const int* row_ptr;
  const int* col;
  const float* d;
  const float* s;
  const float* h;
  float* m;
  const int* seed;
  float* out;
  int n_rows, H, C;
  uint32_t thresh;
  float scale, slope;
};

// Forward over the receiver-major CSR (edge id = CSR position) where a
// row's L lanes hold at least its H heads and C <= KC (see the head of
// this file): lane t < R H of the sub-warp over row r (R = L / H) keeps
// to head t % H and takes the edges e0 + t / H, e0 + t / H + R, ... of
// the row, NB of them with their loads issued together, so each (edge,
// head) pair is one lane's and each col[e] is loaded once for all heads.
template <int L, int V, int KC>
__global__ void __launch_bounds__(kThreads)
gat_fwd_rows_kernel(FwdArgs f) {
  // edges a lane loads at once: kEdgeLoads, one where a head is wide
  constexpr int NB = KC <= 8 ? kEdgeLoads : 1;
  const Row<L> row;
  const int r = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int n_rows = f.n_rows;
  if (r >= n_rows) return;
  const int H = f.H, C = f.C, HC = H * C;
  const size_t rrow = static_cast<size_t>(r);
  const float slope = f.slope;
  // R entry groups of H lanes; the L - R H lanes past them (where H does
  // not divide L) walk no edge and only join the sums
  const int hd = row.lane % H;
  const int r0 = row.lane / H;
  const int R = L / H;
  const uint32_t seed = static_cast<uint32_t>(__ldg(f.seed));
  // the row's own term: d of the head
  const float dr = __ldg(f.d + rrow * H + hd);
  const int e_begin = __ldg(f.row_ptr + r);
  const int e_end = __ldg(f.row_ptr + r + 1);
  // the row's shift: the largest s of the head over its senders, in a walk
  // of its own (NB senders a lane at once), the entry groups' maxima met
  // and sent back to every lane of the head; 0 for a row without edges
  float mx = -INFINITY;
  for (int e = r0 < R ? e_begin + r0 : e_end; e < e_end; e += R * NB) {
    int src[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int eb = e + b * R;
      src[b] = eb < e_end ? __ldg(f.col + eb) : -1;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (src[b] >= 0) {
        mx = fmaxf(mx, __ldg(f.s + static_cast<size_t>(src[b]) * H + hd));
      }
    }
  }
  mx = e_end > e_begin ? row.max_groups(mx, r0, H, R) : 0.f;
  if (r0 == 0) f.m[rrow * H + hd] = mx;
  const float shift = leaky(mx + dr, slope);
  float acc[KC], den = 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  for (int e = r0 < R ? e_begin + r0 : e_end; e < e_end; e += R * NB) {
    // NB edges: the senders, then every gather, issued together
    int src[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int eb = e + b * R;
      src[b] = eb < e_end ? __ldg(f.col + eb) : r;
    }
    float x[NB][KC], sv[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bool ok = e + b * R < e_end;
      const size_t srow = static_cast<size_t>(src[b]);
      load_head<KC, V>(f.h + srow * HC + hd * C, ok ? C : 0, x[b]);
      sv[b] = ok ? __ldg(f.s + srow * H + hd) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int eb = e + b * R;
      if (eb >= e_end) continue;
      const float ex = expf(leaky(sv[b] + dr, slope) - shift);
      den += ex;
      const float w = ex * keep_scale(seed, eb, hd, f.thresh, f.scale);
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] += w * x[b][k];
    }
  }
  // the entry groups' sums meet in group 0 in a fixed tree, a level at a
  // time for the head's C channels and den together
  row.sum_groups(acc, C, den, r0, H, R);
  if (r0 == 0) {
    float* o = f.out + rrow * (HC + H);
    store_head<KC, V>(o + hd * C, C, acc);
    o[HC + hd] = den;
  }
}


// Backward over one CSR, first design (see the head of this file): group
// (r, hd) over row r.
//   kSrc = false: rows are receivers (receiver-major CSR, edge id = CSR
//                 position); writes dd (n_rows, H) into out_h.
//   kSrc = true:  rows are senders (sender-major CSR, edge id = eid[p]);
//                 writes ds (n_rows, H) into out_h and dh (n_rows, H*C).
// g is (n_rows, H*C + H): gnum, then gden.
template <int G, bool kSrc>
__global__ void __launch_bounds__(kThreads)
gat_bwd_heads_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col,
                     const int* __restrict__ eid,
                     const float* __restrict__ d,
                     const float* __restrict__ s,
                     const float* __restrict__ h,
                     const float* __restrict__ m,
                     const float* __restrict__ g,
                     const int* __restrict__ seed_ptr,
                     float* __restrict__ out_h, float* __restrict__ dh,
                     int n_rows, int H, int C, uint32_t thresh, float scale,
                     float slope) {
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
  // the row's own node terms: d (and m) of a receiver, s of a sender
  const float own = __ldg((kSrc ? s : d) + static_cast<size_t>(r) * H + hd);
  const float m_own =
      kSrc ? 0.f : __ldg(m + static_cast<size_t>(r) * H + hd);
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  for (int c0 = 0; c0 < C; c0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    float dsum = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int other = __ldg(col + e);
      const int id = kSrc ? __ldg(eid + e) : e;
      const int recv = kSrc ? other : r;
      const int send = kSrc ? r : other;
      const float dr =
          kSrc ? __ldg(d + static_cast<size_t>(other) * H + hd) : own;
      const float sv =
          kSrc ? own : __ldg(s + static_cast<size_t>(other) * H + hd);
      const float mh =
          kSrc ? __ldg(m + static_cast<size_t>(other) * H + hd) : m_own;
      const float zpre = sv + dr;
      const float zl = leaky(zpre, slope) - leaky(mh + dr, slope);
      const float ex = expf(zl);
      const float ks = keep_scale(seed, id, hd, thresh, scale);
      const float* gn = g + static_cast<size_t>(recv) * ldg + hd * C;
      if (kSrc) {
        const float w = ex * ks;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int c = c0 + lane + k * G;
          if (c < C) acc[k] += __ldg(gn + c) * w;
        }
      }
      if (c0 == 0) {
        const float* hs = h + static_cast<size_t>(send) * HC + hd * C;
        float part = 0.f;
        for (int c = lane; c < C; c += G) part += __ldg(gn + c) * __ldg(hs + c);
        const float dot = group_sum<G>(part, mask);
        const float gden = __ldg(g + static_cast<size_t>(recv) * ldg + HC + hd);
        const float dz = ex * (ks * dot + gden);
        dsum += zpre > 0.f ? dz : slope * dz;
      }
    }
    if (kSrc) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int c = c0 + lane + k * G;
        if (c < C) dh[static_cast<size_t>(r) * HC + hd * C + c] = acc[k];
      }
    }
    if (c0 == 0 && lane == 0) out_h[static_cast<size_t>(r) * H + hd] = dsum;
    if (!kSrc) break;  // the receiver side has no per-channel output
  }
}

// The backward's arguments beside the lane map.
struct BwdArgs {
  const int* row_ptr;
  const int* col;
  const int* eid;
  const float* d;
  const float* s;
  const float* h;
  const float* m;
  const float* g;
  const int* seed;
  float* out_h;
  float* dh;
  int n_rows, H, C;
  uint32_t thresh;
  float scale, slope;
};

// Backward over one CSR (kSrc as gat_bwd_heads_kernel), where the H heads
// divide the L lanes of a row and C <= KC (see the head of this file):
// lane t of the sub-warp over row r keeps to head t % H and takes the
// edges e0 + t / H, e0 + t / H + L / H, ... of the row, NB of them with
// their loads issued together, so each (edge, head) pair is one lane's.
// kAblate and sink: see the head (0 and 0 in the library).
template <int L, int V, int KC, bool kSrc, unsigned kAblate = 0>
__global__ void __launch_bounds__(kThreads)
gat_bwd_kernel(BwdArgs a, int sink) {
  using namespace gat_ablate;
  // edges a lane loads at once: kEdgeLoads, one where a head is wide
  constexpr int NB = KC <= 8 ? kEdgeLoads : 1;
  constexpr bool kIndex = !(kAblate & kNoIndex);
  constexpr bool kGatherS = !(kAblate & kNoGatherS);
  constexpr bool kGatherG = !(kAblate & kNoGatherG);
  constexpr bool kGatherH = !(kAblate & kNoGatherH);
  // the gather of the neighbour's row: h[src] in walk 0, gnum[dst] in 1
  constexpr bool kGatherRow = kSrc ? kGatherG : kGatherH;
  const Row<L> row;
  const int r = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (r >= a.n_rows) return;
  const int H = a.H, C = a.C, HC = H * C;
  const size_t ldg = static_cast<size_t>(HC + H);
  const size_t rrow = static_cast<size_t>(r);
  const float slope = a.slope;
  const int hd = row.lane % H;
  const int r0 = row.lane / H;
  const int R = L / H;
  const size_t rh = rrow * H + hd;
  const uint32_t seed = static_cast<uint32_t>(__ldg(a.seed));
  const bool stores = !(kAblate & kNoStore) || sink != 0;
  // the row's own terms: d (walk 0) or s (walk 1) of the head, walk 0's
  // shift and gden, and the head's channels of gnum (walk 0) or h (1)
  const float own = __ldg((kSrc ? a.s : a.d) + rh);
  const float shift = kSrc ? 0.f : leaky(__ldg(a.m + rh) + own, slope);
  const float gden_own = kSrc ? 0.f : __ldg(a.g + rrow * ldg + HC + hd);
  const float* g_row = a.g + rrow * ldg + hd * C;
  const float* h_row = a.h + rrow * HC + hd * C;
  float mine[KC], x_own[KC];
  load_head<KC, V>(kSrc ? h_row : g_row, C, mine);
  // stand-ins for removed gathers: the row's own values, loaded once
  load_head<KC, V>(kSrc ? g_row : h_row, kGatherRow ? 0 : C, x_own);
  const float t_own = kGatherS ? 0.f : __ldg((kSrc ? a.d : a.s) + rh);
  const float m_nb_own = kSrc && !kGatherS ? __ldg(a.m + rh) : 0.f;
  const float gden_nb_own =
      kSrc && !kGatherG ? __ldg(a.g + rrow * ldg + HC + hd) : 0.f;
  const int e0 = __ldg(a.row_ptr + r);
  const int e1 = __ldg(a.row_ptr + r + 1);
  float acc[KC], dsum = 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  for (int e = e0 + r0; e < e1; e += R * NB) {
    // NB edges: the indices, then every gather, issued together
    int nb[NB], id[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int eb = e + b * R;
      const bool ok = eb < e1;
      nb[b] = ok && kIndex ? __ldg(a.col + eb) : r;
      id[b] = kSrc ? (ok ? __ldg(a.eid + eb) : 0) : eb;
    }
    float x[NB][KC], tv[NB], mv[NB], gv[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bool ok = e + b * R < e1;
      const size_t nrow = static_cast<size_t>(nb[b]);
      if (kGatherRow) {
        load_head<KC, V>(kSrc ? a.g + nrow * ldg + hd * C
                              : a.h + nrow * HC + hd * C,
                         ok ? C : 0, x[b]);
      } else {
#pragma unroll
        for (int k = 0; k < KC; ++k) x[b][k] = x_own[k];
      }
      tv[b] = ok ? (kGatherS ? __ldg((kSrc ? a.d : a.s) + nrow * H + hd)
                             : t_own)
                 : 0.f;
      // walk 1: the receiver's shift term beside its d
      mv[b] = kSrc && ok ? (kGatherS ? __ldg(a.m + nrow * H + hd) : m_nb_own)
                         : 0.f;
      gv[b] = kSrc && ok ? (kGatherG ? __ldg(a.g + nrow * ldg + HC + hd)
                                     : gden_nb_own)
                         : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (e + b * R >= e1) continue;
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < C) dot += x[b][k] * mine[k];
      }
      const float dr = kSrc ? tv[b] : own;
      const float zpre = (kSrc ? own : tv[b]) + dr;
      const float zl =
          leaky(zpre, slope) - (kSrc ? leaky(mv[b] + dr, slope) : shift);
      const float ex = (kAblate & kNoExp) ? zl : expf(zl);
      const float ks = (kAblate & kNoDrop)
                           ? a.scale
                           : keep_scale(seed, id[b], hd, a.thresh, a.scale);
      const float dz = ex * (ks * dot + (kSrc ? gv[b] : gden_own));
      dsum += zpre > 0.f ? dz : slope * dz;
      if (kSrc) {
        // one gathered gnum[dst] row: the dot above and dh here
        const float w = ex * ks;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] += w * x[b][k];
      }
    }
  }
  // the entry groups' sums meet (the only shuffles: the dot is one
  // lane's, so kNoShuffle removes these instead)
  if (!(kAblate & kNoShuffle)) {
    dsum = row.sum_from(dsum, H);
    if (kSrc) {
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] = row.sum_from(acc[k], H);
    }
  }
  if (r0 == 0 && stores) {
    if (kSrc) store_head<KC, V>(a.dh + rrow * HC + hd * C, C, acc);
    a.out_h[rh] = dsum;
  }
}

// The wide-head map (gat_fwd_wide_kernel, gat_bwd_wide_kernel; see the
// head of this file): warp w owns head w % H of row w / H; lane t keeps
// the channels c0 + (k 32 + t) V + v (k < K, v < V) of each pass of
// W = 32 V K channels from c0, so that each gather of the warp reads 32 V
// consecutive channels of the neighbour's head. The row's edges go 32 at
// a time, one a lane: the lane loads its edge's index (and, in walk 1,
// its edge id) and forms the (edge, head) scalars once; the walk hands
// them round by shuffles and issues the gathers of NB edges together.
template <int V, int K>
struct WideMap {
  static constexpr int W = 32 * V * K;              // channels a pass
  static constexpr int NB = V * K < 8 ? 8 / (V * K) : 1;
};

// This lane's K V channels of a pass from c0 of the head slice at p (0
// past C).
template <int V, int K>
__device__ __forceinline__ void load_wide(const float* p, int c0, int C,
                                          int lane, float (&x)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + (k * 32 + lane) * V;
    if (c < C) {
      load_vec<V>(p + c, x[k]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[k][v] = 0.f;
    }
  }
}

template <int V, int K>
__device__ __forceinline__ void store_wide(float* p, int c0, int C, int lane,
                                           const float (&x)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + (k * 32 + lane) * V;
    if (c < C) store_vec<V>(p + c, x[k]);
  }
}

// Forward, wide-head map: warp w over (row w / H, head w % H) of the
// receiver-major CSR (edge id = CSR position). The shift's walk loads
// each of the row's senders and its s once, a lane an edge, and keeps the
// first 32 for the walk that sums. Each channel of num, and den, is summed
// over the row's edges in CSR order from 0, as the first design sums them,
// so num, den and m are bitwise the first design's.
template <int V, int K>
__global__ void __launch_bounds__(kThreads)
gat_fwd_wide_kernel(FwdArgs f) {
  using Map = WideMap<V, K>;
  constexpr int NB = Map::NB;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int H = f.H, C = f.C, HC = H * C;
  if (warp >= static_cast<long long>(f.n_rows) * H) return;  // whole warp
  const int r = static_cast<int>(warp / H);
  const int hd = static_cast<int>(warp - static_cast<long long>(r) * H);
  const Row<32> row;
  const int lane = row.lane;
  const size_t rh = static_cast<size_t>(r) * H + hd;
  const float slope = f.slope;
  const uint32_t seed = static_cast<uint32_t>(__ldg(f.seed));
  const float dr = __ldg(f.d + rh);
  const int row_begin = __ldg(f.row_ptr + r);
  const int row_end = __ldg(f.row_ptr + r + 1);
  // the first 32 senders and their s, a lane each
  const bool first = row_begin + lane < row_end;
  const int src_first = first ? __ldg(f.col + row_begin + lane) : 0;
  const float s_first =
      first ? __ldg(f.s + static_cast<size_t>(src_first) * H + hd)
            : -INFINITY;
  // the row's shift: the largest s of the head over its senders; 0 for a
  // row without edges
  float mx = s_first;
  for (int e = row_begin + 32 + lane; e < row_end; e += 32) {
    mx = fmaxf(mx, __ldg(f.s + static_cast<size_t>(__ldg(f.col + e)) * H + hd));
  }
  mx = row_end > row_begin ? row.max_from(mx, 1) : 0.f;
  const float shift = leaky(mx + dr, slope);
  const float* h_head = f.h + hd * C;
  float* o = f.out + static_cast<size_t>(r) * (HC + H);
  for (int c0 = 0; c0 < C; c0 += Map::W) {
    float acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
    }
    float den = 0.f;
    for (int e = row_begin; e < row_end; e += 32) {
      const int n = row_end - e < 32 ? row_end - e : 32;
      int src = src_first;
      float sv = s_first;
      if (e != row_begin) {
        src = lane < n ? __ldg(f.col + e + lane) : 0;
        sv = lane < n ? __ldg(f.s + static_cast<size_t>(src) * H + hd) : 0.f;
      }
      // this lane's edge: its exp and weight, formed once
      float ex = 0.f, w = 0.f;
      if (lane < n) {
        ex = expf(leaky(sv + dr, slope) - shift);
        w = ex * keep_scale(seed, e + lane, hd, f.thresh, f.scale);
      }
      for (int b0 = 0; b0 < n; b0 += NB) {
        // the gathers of NB edges, issued together
        float exb[NB], wb[NB], x[NB][K][V];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int j = (b0 + b) & 31;
          const int sb = __shfl_sync(0xffffffffu, src, j);
          exb[b] = __shfl_sync(0xffffffffu, ex, j);
          wb[b] = __shfl_sync(0xffffffffu, w, j);
          load_wide<V, K>(h_head + static_cast<size_t>(sb) * HC, c0,
                          b0 + b < n ? C : 0, lane, x[b]);
        }
        // then the sums, in CSR order
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b0 + b < n) {
            den += exb[b];
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
              for (int v = 0; v < V; ++v) acc[k][v] += wb[b] * x[b][k][v];
            }
          }
        }
      }
    }
    store_wide<V, K>(o + hd * C, c0, C, lane, acc);
    if (c0 == 0 && lane == 0) {
      o[HC + hd] = den;
      f.m[rh] = mx;
    }
  }
}

// Backward over one CSR, wide-head map (kSrc as gat_bwd_heads_kernel):
// warp w over (row w / H, head w % H). The per-edge dot <gnum[dst],
// h[src]> enters dd and ds only through dz, linearly, so its sum over a
// row's edges is taken channel by channel first: each lane keeps
// t[c] = sum_e sf_e ex_e ks_e x_e[c] (sf_e = 1 or slope by the sign of
// zpre, x_e the gathered neighbour's head: h[src] in walk 0, gnum[dst] in
// walk 1) beside the row's own head (gnum[r] in walk 0, h[r] in walk 1),
// and dd (or ds) = sum_c own[c] t[c] + sum_e sf_e ex_e gden[dst] is one
// sum over the warp's lanes a row, not a reduction an edge. In walk 1 the
// one gathered gnum[dst] row serves t and dh[src] += gnum ex ks, which
// each lane sums channel by channel in CSR order from 0, as the first
// design does, so dh is bitwise the first design's.
template <int V, int K, bool kSrc>
__global__ void __launch_bounds__(kThreads)
gat_bwd_wide_kernel(BwdArgs a) {
  using Map = WideMap<V, K>;
  constexpr int NB = Map::NB;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int H = a.H, C = a.C, HC = H * C;
  if (warp >= static_cast<long long>(a.n_rows) * H) return;  // whole warp
  const int r = static_cast<int>(warp / H);
  const int hd = static_cast<int>(warp - static_cast<long long>(r) * H);
  const Row<32> row;
  const int lane = row.lane;
  const size_t ldg = static_cast<size_t>(HC + H);
  const size_t rrow = static_cast<size_t>(r);
  const size_t rh = rrow * H + hd;
  const float slope = a.slope;
  const uint32_t seed = static_cast<uint32_t>(__ldg(a.seed));
  // the row's own terms: d (walk 0) or s (walk 1) of the head, walk 0's
  // shift and gden, and the head's channels of gnum (walk 0) or h (1)
  const float own = __ldg((kSrc ? a.s : a.d) + rh);
  const float shift = kSrc ? 0.f : leaky(__ldg(a.m + rh) + own, slope);
  const float gden_own = kSrc ? 0.f : __ldg(a.g + rrow * ldg + HC + hd);
  const float* own_head = kSrc ? a.h + rrow * HC + hd * C
                               : a.g + rrow * ldg + hd * C;
  // the gathered neighbour's head: gnum[dst] (walk 1) or h[src] (walk 0)
  const float* nb_head = (kSrc ? a.g : a.h) + hd * C;
  const size_t nb_stride = kSrc ? ldg : static_cast<size_t>(HC);
  const int row_begin = __ldg(a.row_ptr + r);
  const int row_end = __ldg(a.row_ptr + r + 1);
  float part = 0.f;  // this lane's share of dd (walk 0) or ds (walk 1)
  for (int c0 = 0; c0 < C; c0 += Map::W) {
    float mine[K][V], t[K][V], dh[K][V];
    load_wide<V, K>(own_head, c0, C, lane, mine);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) t[k][v] = dh[k][v] = 0.f;
    }
    for (int e = row_begin; e < row_end; e += 32) {
      const int n = row_end - e < 32 ? row_end - e : 32;
      // this lane's edge: its index and terms, loaded and formed once
      const bool mine_edge = lane < n;
      const int p = e + lane;
      const int nb = mine_edge ? __ldg(a.col + p) : 0;
      float w = 0.f, coef = 0.f;
      if (mine_edge) {
        int id = p;
        if constexpr (kSrc) id = __ldg(a.eid + p);
        const size_t nh = static_cast<size_t>(nb) * H + hd;
        const float tv = __ldg((kSrc ? a.d : a.s) + nh);
        const float dr = kSrc ? tv : own;
        const float zpre = (kSrc ? own : tv) + dr;
        const float zl = leaky(zpre, slope) -
                         (kSrc ? leaky(__ldg(a.m + nh) + dr, slope) : shift);
        const float ex = expf(zl);
        w = ex * keep_scale(seed, id, hd, a.thresh, a.scale);
        const float sf = zpre > 0.f ? 1.f : slope;
        coef = sf * w;
        if (c0 == 0) {
          const float gden =
              kSrc ? __ldg(a.g + static_cast<size_t>(nb) * ldg + HC + hd)
                   : gden_own;
          part += sf * (ex * gden);
        }
      }
      for (int b0 = 0; b0 < n; b0 += NB) {
        // the gathers of NB edges, issued together
        float wb[NB], cb[NB], x[NB][K][V];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int j = (b0 + b) & 31;
          const int nbb = __shfl_sync(0xffffffffu, nb, j);
          wb[b] = __shfl_sync(0xffffffffu, w, j);
          cb[b] = __shfl_sync(0xffffffffu, coef, j);
          load_wide<V, K>(nb_head + static_cast<size_t>(nbb) * nb_stride, c0,
                          b0 + b < n ? C : 0, lane, x[b]);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b0 + b < n) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                t[k][v] += cb[b] * x[b][k][v];
                if (kSrc) dh[k][v] += wb[b] * x[b][k][v];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) part += mine[k][v] * t[k][v];
    }
    if (kSrc) store_wide<V, K>(a.dh + rrow * HC + hd * C, c0, C, lane, dh);
  }
  part = row.sum_from(part, 1);
  if (lane == 0) a.out_h[rh] = part;
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

// The fewest of 4, 8, 16 and 32 lanes that hold the H C channels at V a
// lane.
int fewest_lanes(int H, int C, int V) {
  int L = 4;
  while (L < 32 && L * V < H * C) L *= 2;
  return L;
}

// Lanes of a row of gat_bwd_kernel: the fewest that hold the channels;
// twice that where the n_rows rows at that width fill less than one wave
// of the card, so that twice the edges of a row go at once.
int packed_lanes(int H, int C, int V, int n_rows) {
  int L = fewest_lanes(H, C, V);
  if (L < 32 && static_cast<long long>(n_rows) * L < wave_threads()) L *= 2;
  return L;
}

// Lanes of a row of gat_bwd_kernel: packed_lanes's where the heads divide
// them, else 0 (the wide-head map past 32 channels a head, else the first
// design).
int bwd_lanes(int H, int C, int V, int n_rows) {
  const int L = packed_lanes(H, C, V, n_rows);
  return L % H == 0 ? L : 0;
}

// Lanes of a row of gat_fwd_rows_kernel: the fewest that hold the
// channels, and twice that only where a step of the walk at the fewest
// takes fewer than 8 of a row's edges (L / H entry groups of NB edges
// each) and the rows fill less than one wave. A step of 8 or more already
// takes a row of a citation graph (Cora's and PubMed's: means ~4.5, p99
// ~11 edges) in one or two steps, and twice the lanes would add threads
// and a level of the tree of sums to every row (Cora (1, 7), RCM-PubMed
// (1, 3): probes/packed_gat_variants.py, PERF.md). The heads need not
// divide the lanes; 0 (the wide-head map) where a row has fewer lanes
// than heads.
int fwd_lanes(int H, int C, int V, int n_rows) {
  int L = fewest_lanes(H, C, V);
  const int step = L / H * (C <= 8 ? kEdgeLoads : 1);
  if (L < 32 && step < 8 &&
      static_cast<long long>(n_rows) * L < wave_threads()) {
    L *= 2;
  }
  return L >= H ? L : 0;
}

// Where the row map takes (H, C) (lanes_of gives the lanes of a row, not
// 0, and C <= 32), calls f(L, V, KC) as integral constants (V = 4 where C
// is a multiple of 4 and `aligned`: every node array the lanes load or
// store as float4 16-byte aligned, with its rows; KC = 8 or 32 registers
// for a head's channels) and returns true; else false, and the wide-head
// map (or, for the backward's narrow widths, the first design) runs it.
template <typename Fn>
bool with_row_map(int H, int C, int n_rows, bool aligned,
                  int (*lanes_of)(int, int, int, int), Fn&& f) {
  const int V = channels_per_lane(C, aligned);
  const int L = lanes_of(H, C, V, n_rows);
  if (L == 0 || C > 32) return false;
  with_row_lanes(L, V, [&](auto lanes, auto vec) {
    if (C <= 8) {
      f(lanes, vec, std::integral_constant<int, 8>{});
    } else {
      f(lanes, vec, std::integral_constant<int, 32>{});
    }
  });
  return true;
}

// Whether a backward walk may load and store float4s: h, g, dh and the
// rows of g 16-byte aligned.
bool bwd_aligned(const BwdArgs& a) {
  return aligned16(a.h) && aligned16(a.g) && aligned16(a.dh) &&
         (a.H * a.C + a.H) % 4 == 0;
}

// Whether the forward may: h, out and the rows of out (H C + H floats)
// 16-byte aligned.
bool fwd_aligned(const FwdArgs& f) {
  return aligned16(f.h) && aligned16(f.out) && (f.H * f.C + f.H) % 4 == 0;
}

// The row map of the backward's walk of a.
template <typename Fn>
bool with_bwd_lanes(const BwdArgs& a, Fn&& f) {
  return with_row_map(a.H, a.C, a.n_rows, bwd_aligned(a), bwd_lanes, f);
}

// The row map of the forward.
template <typename Fn>
bool with_fwd_lanes(const FwdArgs& f, Fn&& fn) {
  return with_row_map(f.H, f.C, f.n_rows, fwd_aligned(f), fwd_lanes, fn);
}

// One launch of gat_bwd_kernel<L, V, KC, src_side, kAblate> with `smem`
// bytes of (unused) dynamic shared memory per block; the CUDA error.
template <int L, int V, int KC, unsigned kAblate>
int launch_bwd(const BwdArgs& a, int src_side, int sink, int smem,
               cudaStream_t stream) {
  const auto kernel = src_side ? gat_bwd_kernel<L, V, KC, true, kAblate>
                               : gat_bwd_kernel<L, V, KC, false, kAblate>;
  const int rows = kThreads / L;
  kernel<<<(a.n_rows + rows - 1) / rows, kThreads, smem, stream>>>(a, sink);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(void* row_ptr, void* col, void* eid, void* d, void* s,
                 void* h, void* m, void* g, void* seed, void* out_h,
                 void* dh, int n_rows, int H, int C, unsigned thresh,
                 float scale, float slope) {
  return BwdArgs{static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const int*>(eid),
                 static_cast<const float*>(d),
                 static_cast<const float*>(s),
                 static_cast<const float*>(h),
                 static_cast<const float*>(m),
                 static_cast<const float*>(g),
                 static_cast<const int*>(seed),
                 static_cast<float*>(out_h),
                 static_cast<float*>(dh),
                 n_rows,
                 H,
                 C,
                 thresh,
                 scale,
                 slope};
}

// The first design's backward over one CSR: packed_gat_bwd's arguments.
int launch_bwd_heads(const BwdArgs& a, int src_side, cudaStream_t stream) {
  with_group_width(a.C, [&](auto width) {
    constexpr int G = decltype(width)::value;
    const auto kernel = src_side ? gat_bwd_heads_kernel<G, true>
                                 : gat_bwd_heads_kernel<G, false>;
    kernel<<<blocks_for(a.n_rows, a.H, G), kThreads, 0, stream>>>(
        a.row_ptr, a.col, a.eid, a.d, a.s, a.h, a.m, a.g, a.seed, a.out_h,
        a.dh, a.n_rows, a.H, a.C, a.thresh, a.scale, a.slope);
  });
  return static_cast<int>(cudaGetLastError());
}

FwdArgs fwd_args(void* row_ptr, void* col, void* d, void* s, void* h,
                 void* m, void* seed, void* out, int n_rows, int H, int C,
                 unsigned thresh, float scale, float slope) {
  return FwdArgs{static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const float*>(d),
                 static_cast<const float*>(s),
                 static_cast<const float*>(h),
                 static_cast<float*>(m),
                 static_cast<const int*>(seed),
                 static_cast<float*>(out),
                 n_rows,
                 H,
                 C,
                 thresh,
                 scale,
                 slope};
}

// The wide-head map's launch: n_rows H warps, kThreads a block.
int wide_blocks(int n_rows, int H) {
  const long long threads = static_cast<long long>(n_rows) * H * 32;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

// Calls f(V, K) as integral constants for the wide-head map: the passes
// of 32 V channels that hold a head of C channels, K = ceil(C / (32 V)),
// at most 8 / V (a wider head takes passes of W = 256 channels).
template <int V, int K = 1, typename Fn>
void with_wide_k(int k, Fn&& f) {
  if constexpr (V * K >= 8) {
    f(std::integral_constant<int, V>{}, std::integral_constant<int, K>{});
  } else if (k <= K) {
    f(std::integral_constant<int, V>{}, std::integral_constant<int, K>{});
  } else {
    with_wide_k<V, K + 1>(k, f);
  }
}

// Calls f(V, K) for a head of C channels: V = 4 where C is a multiple of
// 4 and `aligned` (the arrays the lanes load or store as float4 16-byte
// aligned, with their rows), else 1.
template <typename Fn>
void with_wide_map(int C, bool aligned, Fn&& f) {
  const int V = channels_per_lane(C, aligned);
  const int k = (C + 32 * V - 1) / (32 * V);
  if (V == 4) {
    with_wide_k<4>(k, f);
  } else {
    with_wide_k<1>(k, f);
  }
}

// The forward's wide-head map: packed_gat_fwd's arguments.
int launch_fwd_wide(const FwdArgs& f, cudaStream_t stream) {
  with_wide_map(f.C, fwd_aligned(f), [&](auto v, auto k) {
    gat_fwd_wide_kernel<decltype(v)::value, decltype(k)::value>
        <<<wide_blocks(f.n_rows, f.H), kThreads, 0, stream>>>(f);
  });
  return static_cast<int>(cudaGetLastError());
}

// One walk of the backward's wide-head map: packed_gat_bwd's arguments.
int launch_bwd_wide(const BwdArgs& a, int src_side, cudaStream_t stream) {
  with_wide_map(a.C, bwd_aligned(a), [&](auto v, auto k) {
    constexpr int kV = decltype(v)::value, kK = decltype(k)::value;
    const auto kernel = src_side ? gat_bwd_wide_kernel<kV, kK, true>
                                 : gat_bwd_wide_kernel<kV, kK, false>;
    kernel<<<wide_blocks(a.n_rows, a.H), kThreads, 0, stream>>>(a);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: out (n_rows, H*C + H) = num | den over the receiver-major CSR,
// and m (n_rows, H), each row's max of s over its senders (0 for a row
// without edges), which the backward takes. gat_fwd_rows_kernel where its
// lane map takes (H, C), else the wide-head map.
extern "C" int packed_gat_fwd(void* row_ptr, void* col, void* d, void* s,
                              void* h, void* m, void* seed, void* out,
                              int n_rows, int H, int C, unsigned thresh,
                              float scale, float slope, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    const FwdArgs f = fwd_args(row_ptr, col, d, s, h, m, seed, out, n_rows,
                               H, C, thresh, scale, slope);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool lanes = with_fwd_lanes(f, [&](auto l, auto v, auto kc) {
      constexpr int L = decltype(l)::value;
      constexpr int rows = kThreads / L;
      gat_fwd_rows_kernel<L, decltype(v)::value, decltype(kc)::value>
          <<<(n_rows + rows - 1) / rows, kThreads, 0, st>>>(f);
    });
    return lanes ? static_cast<int>(cudaGetLastError())
                 : launch_fwd_wide(f, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward over one CSR, m the forward's (n_rows, H). src_side = 0:
// receiver-major CSR, eid unused (may be null), writes dd (n_rows, H) into
// out_h, dh unused. src_side = 1: sender-major CSR with its edge ids,
// writes ds (n_rows, H) into out_h and dh (n_rows, H*C). gat_bwd_kernel
// where its lane map covers the row in one pass, the wide-head map for a
// head of more than 32 channels, else the first design.
extern "C" int packed_gat_bwd(void* row_ptr, void* col, void* eid, void* d,
                              void* s, void* h, void* m, void* g, void* seed,
                              void* out_h, void* dh, int n_rows, int H, int C,
                              unsigned thresh, float scale, float slope,
                              int src_side, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    const BwdArgs a = bwd_args(row_ptr, col, eid, d, s, h, m, g, seed, out_h,
                               dh, n_rows, H, C, thresh, scale, slope);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc = 0;
    const bool lanes = with_bwd_lanes(a, [&](auto l, auto v, auto kc) {
      rc = launch_bwd<decltype(l)::value, decltype(v)::value,
                      decltype(kc)::value, 0>(a, src_side, 0, 0, st);
    });
    if (lanes) return rc;
    return a.C > 32 ? launch_bwd_wide(a, src_side, st)
                    : launch_bwd_heads(a, src_side, st);
  }
  return static_cast<int>(cudaGetLastError());
}
