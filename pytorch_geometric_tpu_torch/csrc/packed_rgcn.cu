// Basis-decomposed relational (RGCN) aggregation for Hopper (sm_90a), and
// its backward.
//
// Replaces the Pallas kernels pytorch_geometric_tpu/ops/packed_rgcn.py:
// _fwd_kernel (forward) and _bwd_kernel (backward over the sender-major
// pack). Those pack edges into (sender window, receiver window) tiles and
// turn every gather, scatter and per-basis broadcast into a one-hot
// matrix product, because the TPU has no fast random access; here
// row-parallel kernels walk a CSR and read each neighbour's row directly.
//
// Function, per edge e = (src -> dst) with relation et and static weight w:
//   forward:   out[dst, c]   += w * sum_b att[et, b] * xB[src, b*C + c]
//   backward (g = d loss / d out):
//     dxB[src, b*C + c] += w * att[et, b] * g[dst, c]
//     datt[et, b]       += w * sum_c xB[src, b*C + c] * g[dst, c]
// xB is (src_rows, B*C), att (R, B), out and g (n, C), all fp32.
//
// What bounds it: bytes. A call reads one CSR with its relation and
// weight per edge (12 B per edge, 4 B per row), xB (4 B * B*C per source
// row) and att; forward it writes 4 B * C per node, backward it also reads
// g and writes dxB (as large as xB) and datt. It does 2*B*C flops per edge
// forward and 4*B*C backward, far below the card's rate for those bytes.
// A forward that gathered a whole xB row (B*C floats) per edge would move
// more than the bound counts wherever a source row has more than one
// out-edge and misses the L2 (272 MB of gathers against a 47 MB xB at
// MUTAG's conv1).
//
// Design:
// - Forward, two launches:
//   1. rgcn_msg_kernel walks the sender-major CSR (the backward's, with
//      each edge's position in the receiver-major CSR, fwd_pos), so each
//      xB row is read once. A group of 32 / G lanes owns a row: two lanes
//      a channel up to 16 channels (G = 16 / CP rows a warp, so at C = 2
//      eight rows a warp, at C = 16 one), one lane a channel above. The
//      lanes of a row tile (basis, channel): with CP the smallest power of
//      two >= min(C, 32), lane l holds channel l % CP of the bases
//      l / CP, l / CP + LR / CP, ... in registers, 16 of them (all bases
//      up to 32 at two lanes a channel). The group loads et, w and fwd_pos
//      of a batch of edges at once, one edge a lane, and hands them on by
//      shuffle; att (R, B) is staged in shared memory once per block (the
//      grid holds one wave of blocks and its warps stride the rows). Per
//      edge a lane sums att[et, b] xB[row, b, c] over its bases in order,
//      the lanes of one channel meet in a fixed tree of shuffles, and
//      m_e = w_e * that sum is stored at the edge's receiver-major
//      position in an (E, C) fp32 scratch (9.1 MB at MUTAG's conv1,
//      written and read back: 5.4 us at 3.35 TB/s beside the bound).
//   2. The receiver-sorted segment sum (segment_sum.cuh, the sorted GCN's
//      kernel) adds each receiver's messages in CSR order.
//   Both run in a fixed order: no atomics, and two launches agree
//   bitwise. The first design (rgcn_fwd_kernel: a warp per receiver row
//   that gathered each sender's xB row per edge, the same lane tiling,
//   and summed over the row's edges and bases in registers) stays in this
//   source for the probes (probes/packed_rgcn_designs.cu,
//   probes/packed_rgcn_ablate.cu); the new design was faster at every
//   width measured, so the library does not dispatch to it.
// - Backward (sender-major CSR), a warp per row, one walk of the row's
//   edges for both terms: lane b keeps basis b (bases in passes of 32),
//   with its CP channels of the row's own xB[row, b, :] (read once per
//   row, not once per edge) and its dxB[row, b, :] sums in registers (CP
//   the smallest power of two >= min(C, 16); wider rows go in passes of
//   16 channels).
//   The warp loads col, et, w and pos of up to 32 edges at once, one edge
//   a lane, and hands them on by shuffle, so a row of up to 32 edges costs
//   one round trip of indices, and stages the batch's g[dst, :] rows in
//   shared memory, all their loads issued together (16-byte loads where C
//   allows), so the batch's rows cost one more round trip, not one per
//   edge; each lane then reads an edge's row from there (a broadcast) and
//   att[et, b], and each g row serves both terms:
//   dae[e, b] = w * <xB[row, b, :], g[dst, :]>, stored at the edge's
//   relation-major position (an edge's B values leave in one store), and
//   dxB[row, b, :] += att[et, b] * (w * g[dst, :]). The sums keep the
//   first design's order (edges in CSR order, channels in order, the same
//   expression for each product), so dxB and dae, and through the datt
//   kernels datt, are bitwise the first design's
//   (probes/packed_rgcn_designs.cu, which keeps it: a warp per row that
//   walked the edges once per 16 bases for dxB and once more for dae,
//   reloading each edge's indices and g row on every walk). Past 16
//   channels the dot of dae is formed from memory in the first channel
//   pass, in channel order.
// - The walk's time follows how many rows an SM holds at once, each a
//   chain of dependent loads (row_ptr, the indices and the xB row, the g
//   rows, the stores): __launch_bounds__ caps its registers so that
//   min_blocks_of(CP) blocks fit an SM (3 at 16 channels a lane, 80
//   registers; 4 at 8; 5 below). Loading the g rows into registers a few
//   edges at a time (143-255 registers uncapped, 1-2 blocks), the xB
//   slice in shared memory, an L2 prefetch of later rows and the g rows
//   handed on by shuffle were slower (PERF.md).
// - datt is a reduction of all E edges into R*B numbers, done without
//   atomics so that it is deterministic: the backward kernel stores dae
//   (E, B) at each edge's position in relation-major order; a second
//   kernel sums each relation's contiguous range in `splits` equal parts
//   (one block each, warps striding the edges, combined in a fixed order
//   through shared memory) into partial (R, splits, B); a third sums the
//   parts in order into datt. A relation that holds most of the edges is
//   therefore spread over `splits` blocks.
// - No atomics anywhere; every output element is written once, with sums
//   in a fixed order, so two launches agree bitwise, rows without edges
//   are written as 0 and outputs may come from torch.empty.
// - A row with thousands of edges (a hub entity) is walked by its one
//   warp, and a hub receiver's messages are summed by the segment sum's
//   one group of lanes: right, and the tail of the launch. Splitting hub
//   rows is left for a graph that has them, with a measurement.
// - fp32 throughout, no fast-math flags.
//
// Ablation hooks: the backward kernel takes a bit mask kAblate of terms
// to remove (namespace rgcn_ablate) and a run-time flag `sink`. The
// library instantiates kAblate = 0 only; probes/packed_rgcn_ablate.cu
// includes this file and instantiates the others, so a probe times the
// kernel that ships. kNoDxbWalk and kNoDaeWalk remove the dxB and the dae
// term of the one walk (their names are those of the two walks of the
// first design). A removed load is replaced by a value loaded once per
// row, and a removed store is kept behind `if (sink)` (sink = 0 at run
// time), so that nvcc cannot delete the work that feeds it.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W
// (probes/packed_rgcn_designs.py, which times both designs of each
// direction in one run; PERF.md), first design -> this one. Forward, the
// call with its segment sum (3.9 us of it at conv1): MUTAG conv1 (B = 30,
// C = 16, 24,576 rows, 141,864 edges; bound 14.5 us) 79.5 -> 47.0 us,
// conv2 (C = 2; bound 2.3) 25.5 -> 14.3, a hub operator at (5, 33) with
// a receiver row of 3,013 edges and a sender row of 2,511 2.88 -> 1.05 ms
// (the segment sum's hub row 0.22 ms of it). Backward, the call with its
// two datt launches (7.7 us of it): conv1 (bound 28.6 us) 107.6 -> 79.3
// us, conv2 (bound 4.1) 42.8 -> 29.9, the hub operator 5.07 -> 3.99 ms.
// The dae scratch (E, B) fp32, 34 MB at MUTAG, written and read back, is
// not in the bound: 10.2 us of traffic at 3.35 TB/s.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/packed_rgcn.py); each launch goes on
// the caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_lanes.cuh"
#include "segment_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Terms of the backward that an ablation removes, one bit each.
namespace rgcn_ablate {
constexpr unsigned kNoIndex = 1u << 0;     // col[e]: the row itself
constexpr unsigned kNoXb = 1u << 1;        // the row's xB slice: att[b]
constexpr unsigned kNoG = 1u << 2;         // g[col]: the row's own xB
constexpr unsigned kNoDxbWalk = 1u << 3;   // no dxB term
constexpr unsigned kNoDaeWalk = 1u << 4;   // no dae term
constexpr unsigned kNoDaeStore = 1u << 5;  // dae stored only if sink
constexpr unsigned kNoDxbStore = 1u << 6;  // dxB stored only if sink
constexpr unsigned kNoDatt = 1u << 7;      // no datt reduction launches
}  // namespace rgcn_ablate

// Forward: warp = receiver row of the receiver-major CSR; col = sender.
template <int CP>
__global__ void __launch_bounds__(kThreads)
rgcn_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const int* __restrict__ et, const float* __restrict__ w,
                const float* __restrict__ xB, const float* __restrict__ att,
                float* __restrict__ out, int n_rows, int B, int C) {
  constexpr int NB = 32 / CP;  // bases per step
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int cl = lane % CP;
  const int bl = lane / CP;
  const size_t BC = static_cast<size_t>(B) * C;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  for (int c0 = 0; c0 < C; c0 += CP) {
    const int c = c0 + cl;
    const bool cok = c < C;
    float acc = 0.f;
    if (cok) {
      for (int e = e0; e < e1; ++e) {
        const float we = __ldg(w + e);
        const float* ar = att + static_cast<size_t>(__ldg(et + e)) * B;
        const float* xr = xB + static_cast<size_t>(__ldg(col + e)) * BC + c;
#pragma unroll 4
        for (int b = bl; b < B; b += NB) {
          acc += (we * __ldg(ar + b)) * __ldg(xr + static_cast<size_t>(b) * C);
        }
      }
    }
    // add the lanes that hold the same channel (other bases)
#pragma unroll
    for (int o = CP; o < 32; o <<= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (cok && bl == 0) out[static_cast<size_t>(row) * C + c] = acc;
  }
}

// Rows of the sender-major CSR that one warp of the message walk takes
// at once, at CP channels a lane: 32 / G lanes a row, two lanes a channel
// up to 16 channels (at C = 2 eight rows a warp), one above.
__host__ __device__ constexpr int msg_rows_per_warp(int CP) {
  return CP >= 16 ? 1 : 16 / CP;
}

// Bases of the row's xB slice a lane of the message walk holds in
// registers: all of B <= 32 at two lanes a channel, 16 at one (more are
// read from memory for each edge).
constexpr int kMsgSlots = 16;

// The most att floats the message walk stages in shared memory (48 KB);
// a larger table is read from memory.
constexpr int kAttSmemFloats = 12288;

// Blocks of the message walk an SM holds at least: __launch_bounds__
// caps its registers to fit them (80; at 64 the walk spilled).
constexpr int kMsgMinBlocks = 3;

// Forward, launch 1: groups of LR = 32 / G lanes walk the rows of the
// sender-major CSR (a grid-stride loop, so that att is staged once per
// block); row = sender, pos = the edge's position in the receiver-major
// CSR. Writes the message of every edge,
// msg[pos[e], c] = w_e * sum_b att[et_e, b] xB[row, b, c], (E, C) in
// receiver-major order. The lanes of a row tile (basis, channel) as
// rgcn_fwd_kernel's do: lane l holds channel l % CP of the bases l / CP,
// l / CP + LR / CP, ... of the row's xB slice in registers (the first
// kMsgSlots of them), loaded once per row, all loads issued together; the
// group loads et, w and pos of up to LR edges at
// once, one edge a lane, and hands them on by shuffle; per edge a lane
// sums its bases in order, the lanes of one channel meet in a fixed tree
// of shuffles, and the first CP lanes store the message row.
// kAttShared: att (R, B) is staged in shared memory (R * B <=
// kAttSmemFloats), else read from memory.
template <int CP, int G, bool kAttShared>
__global__ void __launch_bounds__(kThreads, kMsgMinBlocks)
rgcn_msg_kernel(const int* __restrict__ row_ptr, const int* __restrict__ et,
                const float* __restrict__ w, const int* __restrict__ pos,
                const float* __restrict__ xB, const float* __restrict__ att,
                float* __restrict__ msg, int n_rows, int R, int B, int C) {
  constexpr int LR = 32 / G;           // lanes of a row
  constexpr int NB = LR / CP;          // bases per step
  constexpr int KS = kMsgSlots;        // bases a lane holds
  static_assert(NB >= 1, "a row's lanes hold at least its CP channels");
  extern __shared__ float att_s[];
  if constexpr (kAttShared) {
    for (int k = threadIdx.x; k < R * B; k += kThreads) {
      att_s[k] = __ldg(att + k);
    }
    __syncthreads();
  }
  const Row<LR> grp;
  const int lane = grp.lane;
  const int cl = lane % CP;
  const int bl = lane / CP;
  const size_t BC = static_cast<size_t>(B) * C;
  for (int row = blockIdx.x * (kThreads / LR) + threadIdx.x / LR;
       row < n_rows; row += gridDim.x * (kThreads / LR)) {   // a group a row
    const int e0 = __ldg(row_ptr + row);
    const int e1 = __ldg(row_ptr + row + 1);
    if (e0 == e1) continue;
    const float* xrow = xB + static_cast<size_t>(row) * BC;
    for (int c0 = 0; c0 < C; c0 += CP) {
      const int c = c0 + cl;
      const bool cok = c < C;
      float xs[KS];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int b = bl + j * NB;
        xs[j] = cok && b < B ? __ldg(xrow + static_cast<size_t>(b) * C + c)
                             : 0.f;
      }
      for (int eb = e0; eb < e1; eb += LR) {
        // the indices of up to LR edges, one edge a lane
        const int me = eb + lane;
        int my_et = 0, my_pos = 0;
        float my_w = 0.f;
        if (me < e1) {
          my_et = __ldg(et + me);
          my_w = __ldg(w + me);
          my_pos = __ldg(pos + me);
        }
        const int ne = min(LR, e1 - eb);
        // two edges at a time where att is in shared memory; one where
        // its loads go to memory, which would spill two edges' worth
#pragma unroll (kAttShared ? 2 : 1)
        for (int k = 0; k < ne; ++k) {
          const int t = grp.bcast(my_et, k);
          const float wk = __shfl_sync(grp.mask, my_w, k, LR);
          const int pk = grp.bcast(my_pos, k);
          const int ar = t * B;
          const auto att_of = [&](int b) {
            return kAttShared ? att_s[ar + b] : __ldg(att + ar + b);
          };
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const int b = bl + j * NB;
            if (b < B) part += att_of(b) * xs[j];
          }
          for (int b = bl + KS * NB; b < B; b += NB) {   // past the slots
            part += att_of(b) * (cok ? __ldg(xrow + static_cast<size_t>(b)
                                             * C + c)
                                     : 0.f);
          }
          // add the lanes that hold the same channel (other bases)
          part = grp.sum_from(part, CP);
          if (cok && bl == 0) {
            msg[static_cast<size_t>(pk) * C + c] = wk * part;
          }
        }
      }
    }
  }
}

// Blocks of the backward walk an SM holds at least, at CP channels a lane:
// __launch_bounds__ caps the registers to fit them (80, 64 and 48).
__host__ __device__ constexpr int min_blocks_of(int CP) {
  return CP >= 16 ? 3 : (CP >= 8 ? 4 : 5);
}

// The first n (at most CP) floats at p into x, 0 past n: as float4 or
// float2 loads where vec (p aligned to them and n a multiple of them).
template <int CP>
__device__ __forceinline__ void load_chunk(const float* p, int n, bool vec,
                                           float (&x)[CP]) {
  if constexpr (CP % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < CP; k += 4) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < n) t = __ldg(reinterpret_cast<const float4*>(p + k));
        x[k] = t.x;
        x[k + 1] = t.y;
        x[k + 2] = t.z;
        x[k + 3] = t.w;
      }
      return;
    }
  } else if constexpr (CP == 2) {
    if (vec) {
      float2 t = make_float2(0.f, 0.f);
      if (n > 0) t = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = t.x;
      x[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < CP; ++k) x[k] = k < n ? __ldg(p + k) : 0.f;
}

// Stores the first n (at most CP) of x at p, as load_chunk reads them.
template <int CP>
__device__ __forceinline__ void store_chunk(float* p, int n, bool vec,
                                            const float (&x)[CP]) {
  if constexpr (CP % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < CP; k += 4) {
        if (k < n) {
          *reinterpret_cast<float4*>(p + k) =
              make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
        }
      }
      return;
    }
  } else if constexpr (CP == 2) {
    if (vec) {
      if (n > 0) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    if (k < n) p[k] = x[k];
  }
}

// Backward: warp = sender row of the sender-major CSR; col = receiver,
// pos = the edge's position in relation-major order. Writes dxB
// (n_rows, B*C) and dae (E, B) in relation-major order in one walk of the
// row's edges (see the head of this file): lane b of a pass keeps basis
// b0 + b, its CP channels of the row's xB and their dxB sums in
// registers; the warp loads the col, et, w and pos of up to 32 edges at
// once, one edge a lane, hands them on by shuffle, and stages the batch's
// g rows in shared memory with its loads issued together; each g row
// serves both terms. vec: C a multiple of the vector width and xB, g, dxB
// aligned to it. kAblate and sink: see the header (0 and 0 in the
// library; kNoIndex needs every row with edges to be a row of g, as a
// sender of a node graph is).
template <int CP, unsigned kAblate = 0, int MB = min_blocks_of(CP)>
__global__ void __launch_bounds__(kThreads, MB)
rgcn_bwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const int* __restrict__ et, const float* __restrict__ w,
                const int* __restrict__ pos, const float* __restrict__ xB,
                const float* __restrict__ att, const float* __restrict__ g,
                float* __restrict__ dxB, float* __restrict__ dae, int n_rows,
                int B, int C, bool vec, int sink) {
  using namespace rgcn_ablate;
  static_assert(CP <= 16, "a lane holds at most 16 channels of a basis");
  static_assert(!(kAblate & kNoDatt),
                "kNoDatt removes the datt launches, not a term of this walk");
  constexpr bool kIndex = !(kAblate & kNoIndex);
  constexpr bool kG = !(kAblate & kNoG);
  constexpr bool kDxb = !(kAblate & kNoDxbWalk);
  constexpr bool kDae = !(kAblate & kNoDaeWalk);
  // the warp's batch of g rows, CP channels each
  __shared__ __align__(16) float g_s[kWarps][32 * CP];
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  float* gw = g_s[warp];
  const size_t BC = static_cast<size_t>(B) * C;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  const float* xrow = xB + static_cast<size_t>(row) * BC;
  float* drow = dxB + static_cast<size_t>(row) * BC;
  const bool dxb_stores = !(kAblate & kNoDxbStore) || sink != 0;
  const bool dae_stores = !(kAblate & kNoDaeStore) || sink != 0;
  // a staged g row in loads of V floats (vec), else of one
  constexpr int V = CP % 4 == 0 ? 4 : 1;
  const int per = vec ? CP / V : CP;
  const int width = vec ? V : 1;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool bok = b < B;
    for (int c0 = 0; c0 < C; c0 += CP) {
      // the dae term is formed once, in the first channel pass: from the
      // registers where they hold the whole basis row, else from memory
      const bool dae_pass = kDae && c0 == 0;
      const int nc = bok ? min(CP, C - c0) : 0;
      float xs[CP], acc[CP];
      load_chunk<CP>(xrow + static_cast<size_t>(b) * C + c0, nc, vec, xs);
      if constexpr ((kAblate & kNoXb) != 0) {
        // stand-in for the row's slice: att[0, b] and the channel
        const float a = bok ? __ldg(att + b) : 0.f;
#pragma unroll
        for (int c = 0; c < CP; ++c) xs[c] = c < nc ? a + c : 0.f;
      }
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[c] = 0.f;
      for (int eb = e0; eb < e1; eb += 32) {
        // the indices of up to 32 edges, one edge a lane
        const int me = eb + lane;
        int my_col = row, my_et = 0, my_pos = 0;
        float my_w = 0.f;
        if (me < e1) {
          if constexpr (kIndex) my_col = __ldg(col + me);
          my_et = __ldg(et + me);
          my_w = __ldg(w + me);
          if (dae_pass) my_pos = __ldg(pos + me);
        }
        const int ne = min(32, e1 - eb);
        if constexpr (kG) {
          __syncwarp();   // the lanes are done with the previous batch
          // the batch's g rows (CP channels from c0), every load issued
          // before any is used
          for (int q0 = 0; q0 < ne * per; q0 += 32) {
            const int q = q0 + lane;
            const int e = min(q / per, ne - 1);
            const int dst = __shfl_sync(kFull, my_col, e);
            if (q < ne * per) {
              const int k = (q % per) * width;
              const float* src = g + static_cast<size_t>(dst) * C + c0 + k;
              float* to = gw + e * CP + k;
              if (V == 4 && vec) {
                float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
                if (c0 + k < C) {
                  t = __ldg(reinterpret_cast<const float4*>(src));
                }
                *reinterpret_cast<float4*>(to) = t;
              } else {
                *to = c0 + k < C ? __ldg(src) : 0.f;
              }
            }
          }
          __syncwarp();
        }
#pragma unroll 2
        for (int k = 0; k < ne; ++k) {
          const int t = __shfl_sync(kFull, my_et, k);
          const float wk = __shfl_sync(kFull, my_w, k);
          const int pk = __shfl_sync(kFull, my_pos, k);
          const int dst = __shfl_sync(kFull, my_col, k);
          float gq[CP];
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            // stand-in for g[col] (kNoG): the lane's own xB values
            gq[c] = kG ? gw[k * CP + c] : xs[c];
          }
          if constexpr (kDxb) {
            const float a =
                bok ? __ldg(att + static_cast<size_t>(t) * B + b) : 0.f;
            // one expression, as the first design's walk had it
#pragma unroll
            for (int c = 0; c < CP; ++c) acc[c] += a * (wk * gq[c]);
          }
          if (dae_pass && bok) {
            float dot = 0.f;
            if (C <= CP) {
#pragma unroll
              for (int c = 0; c < CP; ++c) {
                if (c < C) dot += xs[c] * gq[c];
              }
            } else {
              const float* xb = xrow + static_cast<size_t>(b) * C;
              const float* gr = g + static_cast<size_t>(dst) * C;
              for (int c = 0; c < C; ++c) {
                dot += __ldg(xb + c) * (kG ? __ldg(gr + c) : xs[c % CP]);
              }
            }
            if (dae_stores) {
              dae[static_cast<size_t>(pk) * B + b] = wk * dot;
            }
          }
        }
      }
      if (kDxb && dxb_stores && bok) {
        store_chunk<CP>(drow + static_cast<size_t>(b) * C + c0, nc, vec, acc);
      }
    }
  }
}

// datt, step 1: block (j, r) sums part j of relation r's range of dae
// into partial[(r * splits + j) * B + b].
__global__ void __launch_bounds__(kThreads)
rgcn_datt_partial_kernel(const int* __restrict__ rel_ptr,
                         const float* __restrict__ dae,
                         float* __restrict__ partial, int B, int splits) {
  __shared__ float sm[kWarps][32];
  const int r = blockIdx.y;
  const int j = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long e0 = rel_ptr[r];
  const long long len = rel_ptr[r + 1] - e0;
  const long long lo = e0 + len * j / splits;
  const long long hi = e0 + len * (j + 1) / splits;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    float acc = 0.f;
    if (b < B) {
#pragma unroll 4
      for (long long e = lo + warp; e < hi; e += kWarps) {
        acc += __ldg(dae + e * B + b);
      }
    }
    sm[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && b < B) {
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) total += sm[k][lane];
      partial[(static_cast<size_t>(r) * splits + j) * B + b] = total;
    }
    __syncthreads();
  }
}

// datt, step 2: datt[r, b] = the parts of relation r added in order.
__global__ void __launch_bounds__(kThreads)
rgcn_datt_final_kernel(const float* __restrict__ partial,
                       float* __restrict__ datt, int R, int B, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R * B) return;
  const int r = i / B;
  const int b = i % B;
  float total = 0.f;
  for (int j = 0; j < splits; ++j) {
    total += partial[(static_cast<size_t>(r) * splits + j) * B + b];
  }
  datt[i] = total;
}

int blocks_for(int n_rows) { return (n_rows + kWarps - 1) / kWarps; }

// Blocks of the message walk: a group per row (kWarps * G rows a block)
// up to as many blocks as the card holds at once.
int msg_blocks(int n_rows, int G) {
  const long long wave = wave_threads() / kThreads;
  const int need = blocks_for((n_rows + G - 1) / G);
  return need < wave ? need : static_cast<int>(wave);
}

// Calls f(std::integral_constant<int, CP>{}) with the channel width of C:
// the smallest power of two >= min(C, 32).
template <typename Fn>
void with_channel_width(int C, Fn&& f) {
  if (C <= 1) {
    f(std::integral_constant<int, 1>{});
  } else if (C <= 2) {
    f(std::integral_constant<int, 2>{});
  } else if (C <= 4) {
    f(std::integral_constant<int, 4>{});
  } else if (C <= 8) {
    f(std::integral_constant<int, 8>{});
  } else if (C <= 16) {
    f(std::integral_constant<int, 16>{});
  } else {
    f(std::integral_constant<int, 32>{});
  }
}

// Calls f(std::integral_constant<int, CP>{}) with the backward's channels
// a lane holds: the smallest power of two >= min(C, 16).
template <typename Fn>
void with_bwd_width(int C, Fn&& f) {
  if (C <= 1) {
    f(std::integral_constant<int, 1>{});
  } else if (C <= 2) {
    f(std::integral_constant<int, 2>{});
  } else if (C <= 4) {
    f(std::integral_constant<int, 4>{});
  } else if (C <= 8) {
    f(std::integral_constant<int, 8>{});
  } else {
    f(std::integral_constant<int, 16>{});
  }
}

// Whether the backward at C channels loads and stores the rows of xB, g
// and dxB as float4 (its CP a multiple of 4) or float2 (CP = 2): C a
// multiple of that width and the arrays aligned to it.
bool bwd_vec(int C, const void* xB, const void* g, const void* dxB) {
  const int v = C > 2 ? 4 : (C == 2 ? 2 : 1);
  const uintptr_t mask = static_cast<uintptr_t>(v) * sizeof(float) - 1;
  return v > 1 && C % v == 0 &&
         ((reinterpret_cast<uintptr_t>(xB) | reinterpret_cast<uintptr_t>(g) |
           reinterpret_cast<uintptr_t>(dxB)) & mask) == 0;
}

}  // namespace

// Forward: out (n_rows, C) in two launches, each checked. Launch 1
// (rgcn_msg_kernel) walks the sender-major CSR (send_ptr, n_send rows of
// xB; send_et, send_w and fwd_pos per edge in its order, fwd_pos the
// edge's position in the receiver-major CSR) and writes each edge's
// message into msg (E, C), scratch from the caller; launch 2 sums each
// receiver's messages in CSR order (segment_sum.cuh) over row_ptr, the
// receiver-major CSR's row pointers.
extern "C" int packed_rgcn_fwd(void* row_ptr, void* send_ptr, void* send_et,
                               void* send_w, void* fwd_pos, void* xB,
                               void* att, void* msg, void* out, int n_rows,
                               int n_send, int R, int B, int C,
                               void* stream) {
  if (n_rows <= 0 || B <= 0 || C <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_send > 0) {
    const bool shared = R * B <= kAttSmemFloats;
    const size_t smem = shared ? sizeof(float) * R * B : 0;
    with_channel_width(C, [&](auto width) {
      constexpr int CP = decltype(width)::value;
      constexpr int G = msg_rows_per_warp(CP);
      const auto kernel = shared ? rgcn_msg_kernel<CP, G, true>
                                 : rgcn_msg_kernel<CP, G, false>;
      kernel<<<msg_blocks(n_send, G), kThreads, smem, st>>>(
          static_cast<const int*>(send_ptr), static_cast<const int*>(send_et),
          static_cast<const float*>(send_w), static_cast<const int*>(fwd_pos),
          static_cast<const float*>(xB), static_cast<const float*>(att),
          static_cast<float*>(msg), n_send, R, B, C);
    });
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  segment_sum::dispatch(static_cast<const int*>(row_ptr),
                        static_cast<const float*>(msg),
                        static_cast<float*>(out), n_rows, C, st);
  return static_cast<int>(cudaGetLastError());
}

// Backward over the sender-major CSR (col = receiver; et, w and pos in
// CSR order; pos = position of the edge in relation-major order, rel_ptr
// (R + 1) the relations' ranges there): dxB (n_rows, B*C) and datt (R, B).
// dae (E, B) and partial (R, splits, B) are scratch from the caller.
// Three launches, each checked.
extern "C" int packed_rgcn_bwd(void* row_ptr, void* col, void* et, void* w,
                               void* pos, void* rel_ptr, void* xB, void* att,
                               void* g, void* dxB, void* datt, void* dae,
                               void* partial, int n_rows, int R, int B, int C,
                               int splits, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    with_bwd_width(C, [&](auto width) {
      constexpr int CP = decltype(width)::value;
      rgcn_bwd_kernel<CP><<<blocks_for(n_rows), kThreads, 0, st>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const int*>(et), static_cast<const float*>(w),
          static_cast<const int*>(pos), static_cast<const float*>(xB),
          static_cast<const float*>(att), static_cast<const float*>(g),
          static_cast<float*>(dxB), static_cast<float*>(dae), n_rows, B, C,
          bwd_vec(C, xB, g, dxB), 0);
    });
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (R > 0) {
    rgcn_datt_partial_kernel<<<dim3(splits, R), kThreads, 0, st>>>(
        static_cast<const int*>(rel_ptr), static_cast<const float*>(dae),
        static_cast<float*>(partial), B, splits);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    rgcn_datt_final_kernel<<<(R * B + kThreads - 1) / kThreads, kThreads, 0,
                             st>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(datt), R, B, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
