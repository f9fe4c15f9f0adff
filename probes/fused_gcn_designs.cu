// Design probe of the fused two-layer GCN kernel (csrc/fused_gcn.cu): the
// variants measured before its design was kept, built and timed by
// probes/fused_gcn_designs.py. Not part of the port; variants:
//   1  cooperative, two grid barriers, one thread per node in the per-node
//      step (the first design);
//   2  cooperative, two grid barriers, one thread per (node, feature);
//   3  cooperative, one grid barrier, the per-node step folded into the
//      second gather;
//   4  two plain launches, the per-node step folded into the second gather.
// probe_empty times cooperative launches of an empty kernel with 0-2 grid
// barriers, and a plain empty launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

namespace {
constexpr int kThreads = 256;
constexpr int kMaxWidth = 16;

struct Params {
  const int* row_ptr; const int* col; const float* val; const float* x;
  const float* w2; const float* b1; const int* seed; const float* h1_pre;
  float* mid; float* scratch; float* out;
  int n, H, C; unsigned thresh; float keep; int dropout;
};

__device__ __forceinline__ uint32_t keep_hash(uint32_t f, uint32_t c, uint32_t seed) {
  uint32_t h = f * 0x9E3779B1u + c * 0x85EBCA77u + seed;
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  return h ^ (h >> 15);
}
__device__ __forceinline__ int lanes_for(int w) { return w <= 4 ? 4 : (w <= 8 ? 8 : 16); }

__device__ void aggregate(const Params& p, const float* x, float* out, int F) {
  const int G = lanes_for(F);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = tid % G;
  const int n_groups = gridDim.x * blockDim.x / G;
  for (int r = tid / G; r < p.n; r += n_groups) {
    const int e0 = __ldg(p.row_ptr + r), e1 = __ldg(p.row_ptr + r + 1);
    float acc = 0.f;
    if (lane < F) {
#pragma unroll 4
      for (int e = e0; e < e1; ++e)
        acc += __ldg(p.val + e) * x[static_cast<size_t>(__ldg(p.col + e)) * F + lane];
      out[static_cast<size_t>(r) * F + lane] = acc;
    }
  }
}

// per-element transforms (coalesced)
__device__ void transform_fwd_el(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int total = p.n * p.C, stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int j = t / p.C, c = t - j * p.C;
    float z = 0.f;
    for (int h = 0; h < p.H; ++h) {
      float v = fmaxf(p.mid[static_cast<size_t>(j) * p.H + h] + __ldg(p.b1 + h), 0.f);
      if (p.dropout) v = keep_hash(h, j, seed) < p.thresh ? v / p.keep : 0.f;
      z += v * __ldg(p.w2 + h * p.C + c);
    }
    p.scratch[t] = z;
  }
}
__device__ void transform_bwd_el(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int total = p.n * p.H, stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int j = t / p.H, h = t - j * p.H;
    float s = 0.f;
    for (int c = 0; c < p.C; ++c) s += p.mid[static_cast<size_t>(j) * p.C + c] * __ldg(p.w2 + h * p.C + c);
    bool act = __ldg(p.h1_pre + t) + __ldg(p.b1 + h) > 0.f;
    if (p.dropout) { act = act && keep_hash(h, j, seed) < p.thresh; s = s / p.keep; }
    p.scratch[t] = act ? s : 0.f;
  }
}

// fold: second aggregation computes the per-node step per edge
__device__ void fold_fwd(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane32 = tid & 31, lane = lane32 & 15, half = lane32 >> 4;
  const int n_warps = gridDim.x * blockDim.x / 32;
  const float bh = lane < p.H ? __ldg(p.b1 + lane) : 0.f;
  for (int rb = (tid >> 5) * 2; rb < p.n; rb += n_warps * 2) {
    const int r = rb + half;
    float acc = 0.f;
    if (r < p.n && lane < p.H) {
      const int e0 = __ldg(p.row_ptr + r), e1 = __ldg(p.row_ptr + r + 1);
#pragma unroll 4
      for (int e = e0; e < e1; ++e) {
        const int j = __ldg(p.col + e);
        float v = fmaxf(p.mid[static_cast<size_t>(j) * p.H + lane] + bh, 0.f);
        if (p.dropout) v = keep_hash(lane, j, seed) < p.thresh ? v / p.keep : 0.f;
        acc += __ldg(p.val + e) * v;
      }
    }
    for (int c = 0; c < p.C; ++c) {
      float part = lane < p.H ? acc * __ldg(p.w2 + lane * p.C + c) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off, 16);
      if (r < p.n && lane == 0) p.out[static_cast<size_t>(r) * p.C + c] = part;
    }
  }
}
__device__ void fold_bwd(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int G = lanes_for(p.H);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = tid % G, n_groups = gridDim.x * blockDim.x / G;
  float w[kMaxWidth];
#pragma unroll
  for (int c = 0; c < kMaxWidth; ++c) w[c] = (c < p.C && lane < p.H) ? __ldg(p.w2 + lane * p.C + c) : 0.f;
  const float bh = lane < p.H ? __ldg(p.b1 + lane) : 0.f;
  for (int r = tid / G; r < p.n; r += n_groups) {
    if (lane >= p.H) continue;
    const int e0 = __ldg(p.row_ptr + r), e1 = __ldg(p.row_ptr + r + 1);
    float acc = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int j = __ldg(p.col + e);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxWidth; ++c) if (c < p.C) s += p.mid[static_cast<size_t>(j) * p.C + c] * w[c];
      bool act = __ldg(p.h1_pre + static_cast<size_t>(j) * p.H + lane) + bh > 0.f;
      if (p.dropout) { act = act && keep_hash(lane, j, seed) < p.thresh; s = s / p.keep; }
      acc += __ldg(p.val + e) * (act ? s : 0.f);
    }
    p.out[static_cast<size_t>(r) * p.H + lane] = acc;
  }
}


// first design: one thread per node, each reading and writing its own row
__device__ void transform_fwd_node(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n; j += stride) {
    float hd[kMaxWidth];
#pragma unroll
    for (int h = 0; h < kMaxWidth; ++h) {
      if (h < p.H) {
        float v = fmaxf(p.mid[static_cast<size_t>(j) * p.H + h] + __ldg(p.b1 + h), 0.f);
        if (p.dropout) v = keep_hash(h, j, seed) < p.thresh ? v / p.keep : 0.f;
        hd[h] = v;
      }
    }
    for (int c = 0; c < p.C; ++c) {
      float z = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxWidth; ++h) if (h < p.H) z += hd[h] * __ldg(p.w2 + h * p.C + c);
      p.scratch[static_cast<size_t>(j) * p.C + c] = z;
    }
  }
}
__device__ void transform_bwd_node(const Params& p) {
  const uint32_t seed = static_cast<uint32_t>(__ldg(p.seed));
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n; j += stride) {
    float ga[kMaxWidth];
#pragma unroll
    for (int c = 0; c < kMaxWidth; ++c) if (c < p.C) ga[c] = p.mid[static_cast<size_t>(j) * p.C + c];
    for (int h = 0; h < p.H; ++h) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxWidth; ++c) if (c < p.C) s += ga[c] * __ldg(p.w2 + h * p.C + c);
      bool act = __ldg(p.h1_pre + static_cast<size_t>(j) * p.H + h) + __ldg(p.b1 + h) > 0.f;
      if (p.dropout) { act = act && keep_hash(h, j, seed) < p.thresh; s = s / p.keep; }
      p.scratch[static_cast<size_t>(j) * p.H + h] = act ? s : 0.f;
    }
  }
}
template <bool kBwd> __global__ void __launch_bounds__(kThreads) coop2_node(Params p) {
  cg::grid_group grid = cg::this_grid();
  aggregate(p, p.x, p.mid, kBwd ? p.C : p.H);
  grid.sync();
  if (kBwd) transform_bwd_node(p); else transform_fwd_node(p);
  grid.sync();
  aggregate(p, p.scratch, p.out, kBwd ? p.H : p.C);
}
template <bool kBwd> __global__ void __launch_bounds__(kThreads) coop2_el(Params p) {
  cg::grid_group grid = cg::this_grid();
  aggregate(p, p.x, p.mid, kBwd ? p.C : p.H);
  grid.sync();
  if (kBwd) transform_bwd_el(p); else transform_fwd_el(p);
  grid.sync();
  aggregate(p, p.scratch, p.out, kBwd ? p.H : p.C);
}
template <bool kBwd> __global__ void __launch_bounds__(kThreads) coop1_fold(Params p) {
  cg::grid_group grid = cg::this_grid();
  aggregate(p, p.x, p.mid, kBwd ? p.C : p.H);
  grid.sync();
  if (kBwd) fold_bwd(p); else fold_fwd(p);
}
template <bool kBwd> __global__ void __launch_bounds__(kThreads) k_agg(Params p) {
  aggregate(p, p.x, p.mid, kBwd ? p.C : p.H);
}
template <bool kBwd> __global__ void __launch_bounds__(kThreads) k_fold(Params p) {
  if (kBwd) fold_bwd(p); else fold_fwd(p);
}
__global__ void empty_coop(int nsync) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsync; ++i) grid.sync();
}
__global__ void empty_plain(int) {}

int last_blocks = 0;  // grid of the last launch, read by probe_last_blocks

template <typename K>
int coop(K kernel, Params p, int blocks_cap, cudaStream_t s) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (static_cast<long long>(p.n) * 16 + kThreads - 1) / kThreads;
  int blocks = static_cast<int>(want < per_sm * sms ? want : per_sm * sms);
  if (blocks_cap > 0 && blocks > blocks_cap) blocks = blocks_cap;
  last_blocks = blocks;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads), args, 0, s);
}
}  // namespace

extern "C" int probe_run(int variant, int bwd, void* row_ptr, void* col, void* val, void* x, void* w2, void* b1,
                         void* seed, void* h1_pre, void* mid, void* scratch, void* out, int n, int H, int C,
                         unsigned thresh, float keep, int dropout, int blocks_cap, void* stream) {
  Params p{(const int*)row_ptr, (const int*)col, (const float*)val, (const float*)x, (const float*)w2,
           (const float*)b1, (const int*)seed, (const float*)h1_pre, (float*)mid, (float*)scratch, (float*)out,
           n, H, C, thresh, keep, dropout};
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  const int blocks = (n * 16 + kThreads - 1) / kThreads;
  if (variant == 1) rc = bwd ? coop(coop2_node<true>, p, blocks_cap, s) : coop(coop2_node<false>, p, blocks_cap, s);
  else if (variant == 2) rc = bwd ? coop(coop2_el<true>, p, blocks_cap, s) : coop(coop2_el<false>, p, blocks_cap, s);
  else if (variant == 3) rc = bwd ? coop(coop1_fold<true>, p, blocks_cap, s) : coop(coop1_fold<false>, p, blocks_cap, s);
  else if (variant == 4) {
    last_blocks = blocks;
    if (bwd) { k_agg<true><<<blocks, kThreads, 0, s>>>(p); k_fold<true><<<blocks, kThreads, 0, s>>>(p); }
    else { k_agg<false><<<blocks, kThreads, 0, s>>>(p); k_fold<false><<<blocks, kThreads, 0, s>>>(p); }
  }
  if (rc) return rc;
  return cudaGetLastError();
}

extern "C" int probe_last_blocks() { return last_blocks; }

extern "C" int probe_empty(int coop_launch, int nsync, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (coop_launch) {
    void* args[] = {&nsync};
    int rc = cudaLaunchCooperativeKernel((const void*)empty_coop, dim3(blocks), dim3(kThreads), args, 0, s);
    if (rc) return rc;
  } else {
    empty_plain<<<blocks, kThreads, 0, s>>>(nsync);
  }
  return cudaGetLastError();
}
