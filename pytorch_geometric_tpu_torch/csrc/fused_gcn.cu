// Fused two-layer GCN for Hopper (sm_90a): both aggregations of a 2-layer
// GCN and the elementwise work between them in one cooperative launch per
// direction.
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
// gathers and scatters. Blocks of a GPU run in no order, so phase 2 may
// start only when every row of phase 1 is done: here a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates the three steps of each
// direction, and the grid is sized from the occupancy calculator so that all
// its blocks are resident (a cooperative launch refuses a larger grid rather
// than deadlock). The tiles, windows and one-hot matrices are not carried
// over.
//
// Dropout is the JAX kernel's stateless hash of (feature f, node c, seed),
// in uint32 arithmetic: the same bits as ops/fused_gcn.py:keep_mask, so the
// forward and backward agree without a stored mask.
//
// What bounds it: bytes and latency. Per direction it must read the CSR
// (8 B per edge, 4 B per row), the input (N x H or N x C floats), W2 and
// b1, h1_pre (backward), and write its two outputs and the scratch; at the
// RCM-reordered PubMed GCN (24576 rows, ~113k edges, H = 16, C = 3) that is
// ~3.6 MB, ~1.1 us at 3.35 TB/s. Each aggregation is a chain of dependent
// loads per edge (col, then x[col]), and each barrier costs a few us.
//
// Design:
// - Aggregation steps: a group of G lanes (G = 4, 8 or 16, the smallest
//   power of two >= the width) owns a row at a time, in a grid-stride loop
//   over rows; one lane per feature, edges summed in CSR order, no atomics,
//   so two launches are bitwise equal. Rows with no edges write 0.
// - The per-node step: coalesced, one lane per (node, hidden feature); the
//   forward's C dot products summed over a node's lanes with shuffles.
//   (A first design with one thread per node, each reading and writing its
//   own row, took 22 / 40 us forward / backward at PubMed against 15 / 15.
//   Folding the step into the second gather, one barrier fewer, as one
//   cooperative launch or as two plain launches, was slower in the
//   backward and with dropout at PubMed.)
// - The grid: at most 4 blocks of 256 threads per SM, and no more than
//   can be resident; rows and nodes go in grid-stride loops.
// - Buffers written inside the launch (h1_pre or gA2, and the scratch) are
//   read back with plain loads after the barrier, never through the
//   non-coherent read-only path.
// - Everything is fp32; H <= 16 and C <= 16 (the wrapper checks).
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/fused_gcn.py); the launch goes on the
// caller's stream and each function returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 16;
constexpr int kMaxDevices = 64;
// Blocks per SM at most: a grid barrier costs more the more blocks it
// waits for (1.2 us at 192 blocks, 2.7 us at 1056, measured on an H100),
// and 4 per SM was the fastest of 2, 4 and 8 at the PubMed shapes.
constexpr int kBlocksPerSm = 4;

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
  float* scratch;       // z2 (N, C) forward, dh1 (N, H) backward
  float* out;           // out (N, C) forward, dz1 (N, H) backward
  int n, H, C;
  unsigned thresh;      // keep when hash < thresh
  float keep;           // 1 - rate
  int dropout;          // rate > 0
};

__device__ __forceinline__ uint32_t keep_hash(uint32_t f, uint32_t c,
                                              uint32_t seed) {
  uint32_t h = f * 0x9E3779B1u + c * 0x85EBCA77u + seed;
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ int lanes_for(int width) {
  return width <= 4 ? 4 : (width <= 8 ? 8 : 16);
}

// out[r, :F] = sum_{p in row r} val[p] * x[col[p], :F], rows spread over
// the grid's groups of G lanes. x may have been written earlier in this
// launch, so it is read with plain loads.
__device__ void aggregate(const Params& p, const float* x, float* out,
                          int F) {
  const int G = lanes_for(F);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = tid % G;
  const int n_groups = gridDim.x * blockDim.x / G;
  for (int r = tid / G; r < p.n; r += n_groups) {
    const int e0 = __ldg(p.row_ptr + r);
    const int e1 = __ldg(p.row_ptr + r + 1);
    float acc = 0.f;
    if (lane < F) {
#pragma unroll 4
      for (int e = e0; e < e1; ++e) {
        acc += __ldg(p.val + e) * x[static_cast<size_t>(__ldg(p.col + e)) * F
                                    + lane];
      }
      out[static_cast<size_t>(r) * F + lane] = acc;
    }
  }
}

// z2[j] = W2^T drop(relu(h1_pre[j] + b1)): 16 lanes per node, one per
// hidden feature, so each node's row is one coalesced read and each hash is
// computed once; the C dot products are summed over the 16 lanes with
// shuffles and lane c stores z2[j, c]. Both halves of a warp run the loop
// the same number of times, so every lane takes part in the shuffles.
__device__ void transform_fwd(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = tid % kMaxWidth;
  const int n_warps = gridDim.x * blockDim.x / 32;
  const bool live = lane < p.H;
  const float bh = live ? __ldg(p.b1 + lane) : 0.f;
  for (int jb = (tid / 32) * 2; jb < p.n; jb += n_warps * 2) {
    const int j = jb + (tid / kMaxWidth) % 2;
    float v = 0.f;
    if (live && j < p.n) {
      v = fmaxf(p.mid[static_cast<size_t>(j) * p.H + lane] + bh, 0.f);
      if (p.dropout) {
        v = keep_hash(lane, j, seed) < p.thresh ? v / p.keep : 0.f;
      }
    }
    for (int c = 0; c < p.C; ++c) {
      float part = live ? v * __ldg(p.w2 + lane * p.C + c) : 0.f;
#pragma unroll
      for (int off = kMaxWidth / 2; off > 0; off /= 2) {
        part += __shfl_xor_sync(0xffffffffu, part, off, kMaxWidth);
      }
      if (lane == c && j < p.n) {
        p.scratch[static_cast<size_t>(j) * p.C + c] = part;
      }
    }
  }
}

// dh1[j, h] = (W2 gA2[j])[h] * keep / (1 - rate) * [h1_pre[j, h] + b1 > 0],
// one thread per (node, hidden feature): coalesced reads of h1_pre and
// stores of dh1, the node's C values of gA2 shared by its threads.
__device__ void transform_bwd(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int total = p.n * p.H;
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int j = t / p.H;
    const int h = t - j * p.H;
    float s = 0.f;
    for (int c = 0; c < p.C; ++c) {
      s += p.mid[static_cast<size_t>(j) * p.C + c] * __ldg(p.w2 + h * p.C + c);
    }
    bool act = __ldg(p.h1_pre + t) + __ldg(p.b1 + h) > 0.f;
    if (p.dropout) {
      act = act && keep_hash(h, j, seed) < p.thresh;
      s = s / p.keep;
    }
    p.scratch[t] = act ? s : 0.f;
  }
}

template <bool kBwd>
__global__ void __launch_bounds__(kThreads) fused_gcn_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int w1 = kBwd ? p.C : p.H;  // width of the first aggregation
  const int w2 = kBwd ? p.H : p.C;  // width of the second
  aggregate(p, p.x, p.mid, w1);
  grid.sync();
  if (kBwd) {
    transform_bwd(p);
  } else {
    transform_fwd(p);
  }
  grid.sync();
  aggregate(p, p.scratch, p.out, w2);
}

// The grid of one launch on the current device: at most kBlocksPerSm
// blocks of kThreads on each SM, and never more than can be resident at
// once (the occupancy calculator; a cooperative launch refuses a larger
// grid). Computed once per (kernel, device).
template <bool kBwd>
int grid_cap() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_gcn_kernel<kBwd>, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm) * sms;
  }
  return cached[dev];
}

template <bool kBwd>
int launch(const Params& p, cudaStream_t stream) {
  if (p.n <= 0) return static_cast<int>(cudaSuccess);
  const int cap = grid_cap<kBwd>();
  if (cap <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // enough blocks for a group per row in the widest step, within the cap
  const long long want =
      (static_cast<long long>(p.n) * kMaxWidth + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  Params q = p;
  void* args[] = {&q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_gcn_kernel<kBwd>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch is not sticky
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_gcn_fwd(void* row_ptr, void* col, void* val, void* z1,
                             void* w2, void* b1, void* seed, void* h1_pre,
                             void* z2, void* out, int n, int H, int C,
                             unsigned thresh, float keep, int dropout,
                             void* stream) {
  Params p{static_cast<const int*>(row_ptr), static_cast<const int*>(col),
           static_cast<const float*>(val),   static_cast<const float*>(z1),
           static_cast<const float*>(w2),    static_cast<const float*>(b1),
           static_cast<const int*>(seed),    nullptr,
           static_cast<float*>(h1_pre),      static_cast<float*>(z2),
           static_cast<float*>(out),         n, H, C, thresh, keep, dropout};
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_gcn_bwd(void* row_ptr, void* col, void* val, void* g2,
                             void* w2, void* b1, void* seed, void* h1_pre,
                             void* gA2, void* dh1, void* dz1, int n, int H,
                             int C, unsigned thresh, float keep, int dropout,
                             void* stream) {
  Params p{static_cast<const int*>(row_ptr), static_cast<const int*>(col),
           static_cast<const float*>(val),   static_cast<const float*>(g2),
           static_cast<const float*>(w2),    static_cast<const float*>(b1),
           static_cast<const int*>(seed),    static_cast<const float*>(h1_pre),
           static_cast<float*>(gA2),         static_cast<float*>(dh1),
           static_cast<float*>(dz1),         n, H, C, thresh, keep, dropout};
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}
