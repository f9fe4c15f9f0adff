// Fused two-layer GCN for Hopper (sm_90a): both aggregations of a 2-layer
// GCN and the elementwise work between them in two launches per
// direction, the second a programmatic dependent launch.
//
//   forward, over the receiver-major CSR (A):
//     h1_pre = A z1                                  (N, H), an output
//     z2[j]  = W2^T drop(relu(h1_pre[j] + b1))       (N, C), scratch
//     out    = A z2                                  (N, C)
//   backward, over the transposed CSR (A^T), with g2 = d out:
//     gA2    = A^T g2                                (N, C), an output
//     dh1[j] = (W2 gA2[j]) * keep / (1 - rate) * [h1_pre[j] + b1 > 0]
//                                                    (N, H), scratch
//     dz1    = A^T dh1                               (N, H)
//
// Replaces the Pallas kernel pytorch_geometric_tpu/ops/fused_gcn.py:
// _fused_kernel. That kernel runs phase 1 into a VMEM accumulator and phase
// 2 from it on the TPU's sequential grid, with one-hot products for the
// gathers and scatters. Blocks of a GPU run in no order, so the second
// walk may start only when every row of the first is done: here the
// second walk is a second launch, which Hopper's programmatic dependent
// launch starts before the first ends (its blocks load their CSR, then
// wait in griddepcontrol.wait for the first launch's writes). The tiles,
// windows and one-hot matrices are not carried over.
//
// Dropout is the JAX kernel's stateless hash of (feature f, node c, seed),
// in uint32 arithmetic: the same bits as ops/fused_gcn.py:keep_mask, so the
// forward and backward agree without a stored mask.
//
// What bounds it: bytes and latency. Per direction it must read the CSR
// (8 B per edge, 4 B per row), the input (N x H or N x C floats), W2 and
// b1, h1_pre (backward), and write its two outputs and the scratch; at the
// RCM-reordered PubMed GCN (24576 rows, ~113k edges, H = 16, C = 3) that is
// ~3.6 MB, ~1.1 us at 3.35 TB/s. Each walk is a chain of dependent loads
// per row (row_ptr, then col and val, then x[col]), and each launch costs
// its start.
//
// Design:
// - Both walks are row_lanes.cuh's CSR row walk (sum_row), the one
//   spmm_csr_rows_kernel runs: a sub-warp of L lanes owns a row. P lanes
//   span the walk's channels at V a lane (V = 4, one float4, where the
//   width is a multiple of 4 and the rows are 16-byte aligned; else 1), so
//   R = L / P entry groups share the row: lane t keeps channels
//   (t % P) V ... and loads the edges e0 + t / P, + R, ..., NB of them at
//   once (NB = 16 / R, at most 8), every col and val load and then every
//   gather issued together. The
//   entry groups' partial sums meet in a fixed tree of shuffles
//   (Row::sum_from), so every lane of the row ends with its channels' sums
//   and two calls are bitwise equal. No atomics. Rows with no edges sum to
//   0.
// - L = 4 lanes a row (raised to a walk's P where a width needs more):
//   at PubMed's 24,576 rows that is 384 blocks of 256 threads, all
//   resident at once (__launch_bounds__ caps the registers at 80 for 3
//   blocks an SM), so no group walks a second row; at H = 16 one entry
//   group loads 8 edges a step (rows of mean ~4.6 entries, at most 16).
// - The per-node step runs in the first walk, row by row, since it needs
//   only that row: once the row's lanes hold its aggregate, entry group 0
//   stores it (h1_pre, or gA2), and the lanes form the row of the scratch.
//   Forward: each lane applies b1, relu and the hash dropout to its V
//   hidden features, and for each class the P lanes' partial products
//   with W2 meet in a fixed tree of shuffles (Row::sum_below). Backward:
//   the row's C sums are handed to every lane by shuffles, and lane q
//   forms hidden features 4q .. 4q + 3 (products with W2 in class order,
//   relu's test, the hash). Lanes 0 .. Wp / 4 - 1 store the scratch row
//   as float4s. So no pass reads the first walk's output back.
// - The scratch belongs to the kernel: z2 and dh1 rows are padded to
//   Wp = 4 ceil(width / 4) floats (C = 3 -> 4, C = 7 -> 8), the padding
//   written as 0, so each gather of the second walk is one float4 load.
//   The outputs keep their shapes.
// - The scratch and the first walk's output are read back with plain
//   loads, never through the non-coherent read-only path.
// - Everything is fp32; H <= 16 and C <= 16 (the wrapper checks).
//
// The earlier design (kept in probes/fused_gcn_designs.cu: one cooperative
// launch, a group of 4-16 lanes a row, one lane a feature, the edges one
// after another, a pass of its own for the per-node step, two grid
// barriers) and the same walks as one cooperative launch with one
// barrier (also there) were slower. Warm device us on an NVIDIA H100 80GB
// HBM3 at 700 W (probes/fused_gcn_designs.py, all in one run; PERF.md),
// forward / backward at RCM-PubMed (16, 3), dropout 0.5: the earlier
// design 16.2 / 15.0, one cooperative launch of these walks 12.5 / 11.2,
// two plain launches 11.5 / 10.2, the library's two 10.8 / 9.2 (bound
// 1.4 / 1.9); Cora (16, 7): 9.5 / 8.9 -> 7.4 / 6.4.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/fused_gcn.py); the launches go on the
// caller's stream and each function returns the last launch's
// cudaError_t. The caller gives the scratch as (N, Wp) floats, 16-byte
// aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 16;
// Edges a row loads in one step of the chain.
constexpr int kEdgesPerStep = 16;
// Blocks of 256 threads an SM holds at least: __launch_bounds__ caps the
// registers to fit them (80), so that PubMed's 24,576 rows at 4 lanes a
// row (384 blocks) are all resident at once, each group walking one row.
constexpr int kMinBlocks = 3;
// The library's call: lanes a row and edges a lane loads at once
// (probes/fused_gcn_designs.py timed 4-16 lanes, 4 and 8 edges, and
// beside the two launches a cooperative one at 1-4 blocks an SM).
constexpr int kLanes = 4;
constexpr int kBatch = 8;

// One walk's row map: P lanes across the channels, R = L / P entry
// groups, NB edges a lane loads at once.
struct Walk {
  int P, R, NB;
};

struct Params {
  const int* row_ptr;
  const int* col;
  const float* val;
  const float* x;       // z1 (N, H) forward, g2 (N, C) backward
  const float* w2;      // (H, C)
  const float* b1;      // (H,)
  const int* seed;      // (1,)
  const float* h1_pre;  // (N, H), backward only
  float* mid;           // h1_pre (N, H) forward, gA2 (N, C) backward
  float* scratch;       // z2 (N, Wp) forward, dh1 (N, Wp) backward
  float* out;           // out (N, C) forward, dz1 (N, H) backward
  int n, H, C;
  unsigned thresh;      // keep when hash < thresh
  float keep;           // 1 - rate
  int dropout;          // rate > 0
  int ld;               // Wp: floats a scratch row
  Walk walk1, walk2;    // the first and the second walk
  int vec_out;          // out stored as float4
  int vec_h1;           // h1_pre read as float4 (backward)
};

__device__ __forceinline__ uint32_t keep_hash(uint32_t f, uint32_t c,
                                              uint32_t seed) {
  uint32_t h = f * 0x9E3779B1u + c * 0x85EBCA77u + seed;
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  return h ^ (h >> 15);
}

// V floats at p: through the read-only path (kLdg: inputs of the call)
// or with plain loads (the scratch, which the first walk writes).
template <int V, bool kLdg>
__device__ __forceinline__ void load_row(const float* p, float (&x)[V]) {
  if constexpr (kLdg) {
    load_vec<V>(p, x);
  } else if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

// The first row of this lane's group and the groups' stride over rows.
template <int L>
__device__ __forceinline__ int first_row() {
  return (blockIdx.x * kThreads + threadIdx.x) / L;
}
template <int L>
__device__ __forceinline__ int row_stride() {
  return gridDim.x * (kThreads / L);
}

// A row's CSR range and this lane's first step of its edges.
template <int NB>
struct RowStart {
  int e0, e1;
  EdgeBatch<NB> first;
};

// Row r's start in walk w, loaded before the walk, so that the first
// step's column and weight loads issue right behind row_ptr's and not
// behind the walk's test of the row's end. The CSR is an input of the
// launch: nothing here waits for the first walk.
template <int L, int NB>
__device__ __forceinline__ RowStart<NB> row_start(const Row<L>& row,
                                                  const Params& p,
                                                  const Walk& w, int r) {
  RowStart<NB> s;
  s.e0 = __ldg(p.row_ptr + r);
  s.e1 = __ldg(p.row_ptr + r + 1);
  s.first.load(p.col, p.val, s.e0 + row.lane / w.P, s.e1, w.R, w.NB);
  return s;
}

// acc = the sum over a row's edges e of val[e] * x[col[e], c .. c + V)
// with c = (lane % P) V (0 where c >= width), x rows ld floats apart,
// from the row's start s: row_lanes.cuh's row walk (sum_row), the one
// spmm_csr_rows_kernel runs. Every lane of the row ends with its
// channels' sums.
template <int L, int V, int NB, bool kLdg>
__device__ __forceinline__ void row_sum(const Row<L>& row, const Params& p,
                                        const Walk& w, const float* x,
                                        int ld, int width,
                                        const RowStart<NB>& s,
                                        float (&acc)[V]) {
  const int c = (row.lane & (w.P - 1)) * V;
  sum_row<L, V, NB>(
      row, p.col, p.val, s.e0, s.e1, w.P, w.NB, c < width,
      [&](int j, float(&xv)[V]) {
        load_row<V, kLdg>(x + static_cast<size_t>(j) * ld + c, xv);
      },
      acc, true, s.first);
}

// A lane's V channels of a row of width F at p, from channel c: one
// float4 where vec (V == 4, the whole chunk inside the row, 16-byte
// aligned), else the channels below F one by one.
template <int V>
__device__ __forceinline__ void store_row(float* p, int c, int F,
                                          const float (&x)[V], bool vec) {
  if constexpr (V == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p + c) = make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (c + v < F) p[c + v] = x[v];
  }
}

// Forward, first walk: h1_pre = A z1, and in the same row
// z2[r] = W2^T drop(relu(h1_pre[r] + b1)), padded to p.ld with 0.
template <int L, int V, int NB>
__device__ __forceinline__ void first_walk_fwd(const Params& p) {
  const Row<L> row;
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int c = (row.lane & (p.walk1.P - 1)) * V;  // its hidden features
  float bh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) bh[v] = c + v < p.H ? __ldg(p.b1 + c + v) : 0.f;
  for (int r = first_row<L>(); r < p.n; r += row_stride<L>()) {
    float acc[V];
    row_sum<L, V, NB, true>(row, p, p.walk1, p.x, p.H, p.H,
                            row_start<L, NB>(row, p, p.walk1, r), acc);
    if (row.lane < p.walk1.P && c < p.H) {
      store_row<V>(p.mid + static_cast<size_t>(r) * p.H, c, p.H, acc, true);
    }
    float d[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float t = c + v < p.H ? fmaxf(acc[v] + bh[v], 0.f) : 0.f;
      if (p.dropout) {
        t = keep_hash(c + v, r, seed) < p.thresh ? t / p.keep : 0.f;
      }
      d[v] = t;
    }
    // each class's P partial products meet in a fixed tree
    float z[kMaxWidth];
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) {
      z[k] = 0.f;
      if (k < p.C) {
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (c + v < p.H) part += d[v] * __ldg(p.w2 + (c + v) * p.C + k);
        }
        z[k] = row.sum_below(part, p.walk1.P);
      }
    }
    // lane q stores classes 4q .. 4q + 3 (0 past C)
    float* zr = p.scratch + static_cast<size_t>(r) * p.ld;
#pragma unroll
    for (int q = 0; q < kMaxWidth / 4; ++q) {
      if (row.lane == q && 4 * q < p.ld) {
        *reinterpret_cast<float4*>(zr + 4 * q) =
            make_float4(z[4 * q], z[4 * q + 1], z[4 * q + 2], z[4 * q + 3]);
      }
    }
  }
}

// Backward, first walk: gA2 = A^T g2, and in the same row
// dh1[r] = (W2 gA2[r]) * keep / (1 - rate) * [h1_pre[r] + b1 > 0], padded
// to p.ld with 0.
template <int L, int V, int NB>
__device__ __forceinline__ void first_walk_bwd(const Params& p) {
  const Row<L> row;
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int c = (row.lane & (p.walk1.P - 1)) * V;  // this lane's classes
  const int h0 = 4 * row.lane;  // its hidden features, 4 of them
  const bool forms = h0 < p.ld;
  float bh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bh[k] = forms && h0 + k < p.H ? __ldg(p.b1 + h0 + k) : 0.f;
  }
  for (int r = first_row<L>(); r < p.n; r += row_stride<L>()) {
    // h1_pre's row first: it does not wait for the walk
    float hp[4] = {0.f, 0.f, 0.f, 0.f};
    const float* hr = p.h1_pre + static_cast<size_t>(r) * p.H + h0;
    if (forms && p.vec_h1) {
      load_vec<4>(hr, hp);
    } else if (forms) {
#pragma unroll
      for (int k = 0; k < 4; ++k) hp[k] = h0 + k < p.H ? __ldg(hr + k) : 0.f;
    }
    float acc[V];
    row_sum<L, V, NB, true>(row, p, p.walk1, p.x, p.C, p.C,
                            row_start<L, NB>(row, p, p.walk1, r), acc);
    if (row.lane < p.walk1.P && c < p.C) {
      store_row<V>(p.mid + static_cast<size_t>(r) * p.C, c, p.C, acc, true);
    }
    // the row's C sums, to every lane
    float g[kMaxWidth];
#pragma unroll
    for (int k = 0; k < kMaxWidth; ++k) {
      g[k] = k < p.C ? __shfl_sync(row.mask, acc[k % V], k / V, L) : 0.f;
    }
    if (forms) {
      float dh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = h0 + q;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxWidth; ++k) {
          if (k < p.C && h < p.H) s += g[k] * __ldg(p.w2 + h * p.C + k);
        }
        bool act = h < p.H && hp[q] + bh[q] > 0.f;
        if (p.dropout) {
          act = act && keep_hash(h, r, seed) < p.thresh;
          s = s / p.keep;
        }
        dh[q] = act ? s : 0.f;
      }
      *reinterpret_cast<float4*>(p.scratch + static_cast<size_t>(r) * p.ld +
                                 h0) = make_float4(dh[0], dh[1], dh[2], dh[3]);
    }
  }
}

template <bool kBwd, int L, int V, int NB>
__device__ __forceinline__ void first_walk(const Params& p) {
  if constexpr (kBwd) {
    first_walk_bwd<L, V, NB>(p);
  } else {
    first_walk_fwd<L, V, NB>(p);
  }
}

// The second walk's start of this group's first row, if it has one.
template <int L, int NB>
__device__ __forceinline__ RowStart<NB> second_start(const Params& p) {
  const Row<L> row;
  RowStart<NB> s{};
  const int r = first_row<L>();
  if (r < p.n) s = row_start<L, NB>(row, p, p.walk2, r);
  return s;
}

// The second walk: out = A scratch (forward) or dz1 = A^T scratch
// (backward), width F, the group's first row from `start` (loaded before
// the scratch was complete). The first walk wrote the scratch, so it is
// read with plain loads, one float4 a lane and edge.
template <int L, int NB>
__device__ __forceinline__ void second_walk(const Params& p, int F,
                                            const RowStart<NB>& start) {
  const Row<L> row;
  const int c = (row.lane & (p.walk2.P - 1)) * 4;
  const int r0 = first_row<L>();
  for (int r = r0; r < p.n; r += row_stride<L>()) {
    RowStart<NB> s = start;
    if (r != r0) s = row_start<L, NB>(row, p, p.walk2, r);
    float acc[4];
    row_sum<L, 4, NB, false>(row, p, p.walk2, p.scratch, p.ld, p.ld, s, acc);
    if (row.lane < p.walk2.P && c < F) {
      store_row<4>(p.out + static_cast<size_t>(r) * F, c, F, acc,
                   p.vec_out);
    }
  }
}

// The first walk with the per-node step. It lets the second launch start
// at once (programmatic dependent launch; where a launch is plain the
// instruction does nothing).
template <bool kBwd, int L, int V, int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_gcn_first_kernel(Params p) {
  asm volatile("griddepcontrol.launch_dependents;");
  first_walk<kBwd, L, V, NB>(p);
}

// The second walk, width F. Its blocks load their first row's start in
// the CSR, then wait until the first launch has finished and its writes
// are visible (griddepcontrol.wait: at once where the launch was plain).
template <int L, int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_gcn_second_kernel(Params p, int F) {
  const RowStart<NB> start = second_start<L, NB>(p);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  second_walk<L, NB>(p, F, start);
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// The row map of a walk of F channels at V a lane over L lanes, at most
// NB edges a lane at once.
Walk walk_of(int F, int V, int L, int NB) {
  Walk w;
  w.P = pow2_at_least((F + V - 1) / V);
  w.R = L / w.P;
  const int nb = kEdgesPerStep / w.R;
  w.NB = nb < 1 ? 1 : (nb > NB ? NB : nb);
  return w;
}

// Blocks of a walk: a group of L lanes a row.
template <int L>
int walk_blocks(int n) {
  return static_cast<int>((static_cast<long long>(n) * L + kThreads - 1) /
                          kThreads);
}

// The library's two launches, the second a programmatic dependent launch.
template <bool kBwd, int L, int V, int NB>
int launch_walks(const Params& p, cudaStream_t stream) {
  const int blocks = walk_blocks<L>(p.n);
  fused_gcn_first_kernel<kBwd, L, V, NB><<<blocks, kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  const int F = kBwd ? p.H : p.C;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, fused_gcn_second_kernel<L, NB>, p, F));
}

// Fills in p's scratch row, row maps and vector widths for `lanes` lanes
// a row (a power of two from 4 to 16, raised to each walk's P) and NB
// edges a lane at once, and returns f(p, L, V) with L (4, 8 or 16) and V
// (4 or 1) as integral constants; cudaErrorInvalidValue where the
// buffers do not fit.
template <bool kBwd, int NB, typename Fn>
int with_shape(Params p, int lanes, Fn&& f) {
  if (p.n <= 0) return static_cast<int>(cudaSuccess);
  const int F1 = kBwd ? p.C : p.H;  // width of the first walk
  const int F2 = kBwd ? p.H : p.C;  // and of the second
  p.ld = (F2 + 3) / 4 * 4;
  if (!aligned16(p.scratch) || F1 > kMaxWidth || F2 > kMaxWidth ||
      lanes > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int V1 =
      F1 % 4 == 0 && aligned16(p.x) && aligned16(p.mid) ? 4 : 1;
  const int P1 = pow2_at_least((F1 + V1 - 1) / V1);
  const int P2 = pow2_at_least(p.ld / 4);
  int L = pow2_at_least(lanes < 4 ? 4 : lanes);
  L = L < P1 ? P1 : L;
  L = L < P2 ? P2 : L;
  p.walk1 = walk_of(F1, V1, L, NB);
  p.walk2 = walk_of(p.ld, 4, L, NB);
  p.vec_out = F2 % 4 == 0 && aligned16(p.out);
  p.vec_h1 = kBwd && p.H % 4 == 0 && aligned16(p.h1_pre);
  const auto pick_v = [&](auto l) {
    return V1 == 4 ? f(p, l, std::integral_constant<int, 4>{})
                   : f(p, l, std::integral_constant<int, 1>{});
  };
  if (L == 4) return pick_v(std::integral_constant<int, 4>{});
  if (L == 8) return pick_v(std::integral_constant<int, 8>{});
  return pick_v(std::integral_constant<int, 16>{});
}

// The library's call: both walks at kLanes lanes a row and kBatch edges
// a lane, two launches.
template <bool kBwd>
int launch(const Params& p, cudaStream_t stream) {
  return with_shape<kBwd, kBatch>(
      p, kLanes, [&](const Params& q, auto lanes, auto vec) {
        return launch_walks<kBwd, decltype(lanes)::value,
                            decltype(vec)::value, kBatch>(q, stream);
      });
}

Params params_of(void* row_ptr, void* col, void* val, void* x, void* w2,
                 void* b1, void* seed, void* h1_pre, void* mid,
                 void* scratch, void* out, int n, int H, int C,
                 unsigned thresh, float keep, int dropout) {
  Params p{};
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.col = static_cast<const int*>(col);
  p.val = static_cast<const float*>(val);
  p.x = static_cast<const float*>(x);
  p.w2 = static_cast<const float*>(w2);
  p.b1 = static_cast<const float*>(b1);
  p.seed = static_cast<const int*>(seed);
  p.h1_pre = static_cast<const float*>(h1_pre);
  p.mid = static_cast<float*>(mid);
  p.scratch = static_cast<float*>(scratch);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.H = H;
  p.C = C;
  p.thresh = thresh;
  p.keep = keep;
  p.dropout = dropout;
  return p;
}

}  // namespace

// z2 is the scratch: (n, 4 ceil(C / 4)) floats.
extern "C" int fused_gcn_fwd(void* row_ptr, void* col, void* val, void* z1,
                             void* w2, void* b1, void* seed, void* h1_pre,
                             void* z2, void* out, int n, int H, int C,
                             unsigned thresh, float keep, int dropout,
                             void* stream) {
  return launch<false>(
      params_of(row_ptr, col, val, z1, w2, b1, seed, nullptr, h1_pre, z2,
                out, n, H, C, thresh, keep, dropout),
      static_cast<cudaStream_t>(stream));
}

// dh1 is the scratch: (n, 4 ceil(H / 4)) floats.
extern "C" int fused_gcn_bwd(void* row_ptr, void* col, void* val, void* g2,
                             void* w2, void* b1, void* seed, void* h1_pre,
                             void* gA2, void* dh1, void* dz1, int n, int H,
                             int C, unsigned thresh, float keep, int dropout,
                             void* stream) {
  return launch<true>(
      params_of(row_ptr, col, val, g2, w2, b1, seed, h1_pre, gA2, dh1, dz1,
                n, H, C, thresh, keep, dropout),
      static_cast<cudaStream_t>(stream));
}
