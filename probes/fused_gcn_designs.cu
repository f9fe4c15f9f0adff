// Design probe of the fused two-layer GCN kernel (csrc/fused_gcn.cu), built
// and timed by probes/fused_gcn_designs.py. Not part of the port.
//
// The production source is included, so the shipped design is the
// library's own code: probe_design launches its walks with other values
// of the constants the library fixes (lanes a row, the edges a lane loads
// at once) as its two launches (launch_walks, the second programmatic),
// as two plain launches (launch_plain below), or as one cooperative
// launch with one grid barrier (fused_gcn_coop_kernel below, at most 1-4
// blocks an SM). Beside it, namespace earlier_design keeps the earlier design
// verbatim (a group of 4-16 lanes a row, one lane a feature, the row's
// edges one after another; a pass of its own for the per-node step; two
// grid barriers; the scratch unpadded), launched by probe_earlier with the
// library's arguments.
// probe_empty times cooperative launches of an empty kernel with 0-2 grid
// barriers, and a plain empty launch.

#include <cooperative_groups.h>

#include "../pytorch_geometric_tpu_torch/csrc/fused_gcn.cu"

namespace cg = cooperative_groups;

namespace earlier_design {

int last_blocks = 0;  // grid of the last launch

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
  last_blocks = blocks;
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


}  // namespace earlier_design

namespace {

__global__ void empty_coop(int nsync) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < nsync; ++i) grid.sync();
}

__global__ void empty_plain(int) {}

int last_blocks = 0;  // grid of the last launch of the shipped design

// The shipped walks as one cooperative launch: the second walk's first
// CSR loads, the first walk with the per-node step, one grid barrier, the
// second walk.
template <bool kBwd, int L, int V, int NB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_gcn_coop_kernel(Params p) {
  const RowStart<NB> second = second_start<L, NB>(p);
  first_walk<kBwd, L, V, NB>(p);
  cg::this_grid().sync();
  second_walk<L, NB>(p, kBwd ? p.H : p.C, second);
}

// One cooperative launch: a group a row, at most blocks_per_sm blocks an
// SM and no more than the occupancy calculator lets be resident (the
// groups then walk rows in a grid-stride loop).
template <bool kBwd, int L, int V, int NB>
int launch_coop(const Params& p, int blocks_per_sm, cudaStream_t stream) {
  const auto kernel = fused_gcn_coop_kernel<kBwd, L, V, NB>;
  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = walk_blocks<L>(p.n);
  const long long cap =
      static_cast<long long>(per_sm < blocks_per_sm ? per_sm
                                                    : blocks_per_sm) * sms;
  last_blocks = static_cast<int>(need < cap ? need : cap);
  Params q = p;
  void* args[] = {&q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(last_blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The library's two kernels as two plain launches.
template <bool kBwd, int L, int V, int NB>
int launch_plain(const Params& p, cudaStream_t stream) {
  last_blocks = walk_blocks<L>(p.n);
  fused_gcn_first_kernel<kBwd, L, V, NB>
      <<<last_blocks, kThreads, 0, stream>>>(p);
  fused_gcn_second_kernel<L, NB><<<last_blocks, kThreads, 0, stream>>>(
      p, kBwd ? p.H : p.C);
  return static_cast<int>(cudaGetLastError());
}

// The walks at L lanes a row (raised to the walks' P) and NB edges a lane
// at once, in launch form `form`.
template <bool kBwd, int NB>
int run_design(const Params& p, int lanes, int blocks_per_sm, int form,
               cudaStream_t s) {
  return with_shape<kBwd, NB>(p, lanes, [&](const Params& q, auto l,
                                            auto v) {
    constexpr int L = decltype(l)::value;
    constexpr int V = decltype(v)::value;
    if (form == 0) return launch_coop<kBwd, L, V, NB>(q, blocks_per_sm, s);
    if (form == 1) return launch_plain<kBwd, L, V, NB>(q, s);
    last_blocks = walk_blocks<L>(q.n);
    return launch_walks<kBwd, L, V, NB>(q, s);
  });
}

}  // namespace

// The library's arguments (fused_gcn_fwd's, or fused_gcn_bwd's with bwd),
// the scratch padded as the library's; then the lanes a row, the most
// blocks per SM of the cooperative launch, the launch form (0: one
// cooperative launch, 1: two plain launches, 2: two, the second a
// programmatic dependent launch, as the library's) and the edges a lane
// loads at once, then the stream.
extern "C" int probe_design(int bwd, void* row_ptr, void* col, void* val,
                            void* x, void* w2, void* b1, void* seed,
                            void* h1_pre, void* mid, void* scratch, void* out,
                            int n, int H, int C, unsigned thresh, float keep,
                            int dropout, int lanes, int blocks_per_sm,
                            int form, int batch, void* stream) {
  const Params p = params_of(row_ptr, col, val, x, w2, b1, seed,
                             bwd ? h1_pre : nullptr, mid, scratch, out, n, H,
                             C, thresh, keep, dropout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch != 4 && batch != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bwd) {
    return batch == 4 ? run_design<true, 4>(p, lanes, blocks_per_sm, form, s)
                      : run_design<true, 8>(p, lanes, blocks_per_sm, form, s);
  }
  return batch == 4 ? run_design<false, 4>(p, lanes, blocks_per_sm, form, s)
                    : run_design<false, 8>(p, lanes, blocks_per_sm, form, s);
}

// The earlier design with the same arguments (the scratch unpadded).
extern "C" int probe_earlier(int bwd, void* row_ptr, void* col, void* val,
                             void* x, void* w2, void* b1, void* seed,
                             void* h1_pre, void* mid, void* scratch,
                             void* out, int n, int H, int C, unsigned thresh,
                             float keep, int dropout, void* stream) {
  const earlier_design::Params p{
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(val),   static_cast<const float*>(x),
      static_cast<const float*>(w2),    static_cast<const float*>(b1),
      static_cast<const int*>(seed),    static_cast<const float*>(h1_pre),
      static_cast<float*>(mid),         static_cast<float*>(scratch),
      static_cast<float*>(out),         n, H, C, thresh, keep, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bwd ? earlier_design::launch<true>(p, s)
             : earlier_design::launch<false>(p, s);
}

// The library's constants: lanes a row and edges a lane loads at once.
extern "C" int probe_library_options(int* lanes, int* batch) {
  *lanes = kLanes;
  *batch = kBatch;
  return 0;
}

// The grid of the last launch of either design.
extern "C" int probe_last_blocks(int earlier) {
  return earlier ? earlier_design::last_blocks : last_blocks;
}

extern "C" int probe_empty(int coop_launch, int nsync, int blocks,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coop_launch) {
    void* args[] = {&nsync};
    const cudaError_t rc = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(empty_coop), dim3(blocks),
        dim3(kThreads), args, 0, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  } else {
    empty_plain<<<blocks, kThreads, 0, s>>>(nsync);
  }
  return static_cast<int>(cudaGetLastError());
}
