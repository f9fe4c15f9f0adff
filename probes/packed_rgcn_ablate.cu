// Term-by-term ablation of the packed-RGCN backward, and a forward that
// issues its loads ahead (pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu).
//
// Counterpart of two Pallas probes: tools/rgcn_ablate.py
// (make_bwd_kernel), which copied the TPU backward and removed one TPU
// cost term per variant (one-hot builds, the xB gather, the scatter, the
// block accumulation, the datt sum), and tools/rgcn_pipe_probe.py
// (pipe_fwd_kernel), which built the next tile's one-hots while the
// current tile's products ran. probes/rgcn_ablate.py and
// probes/rgcn_pipe_probe.py drive it.
//
// Backward: the production source is included, and each variant
// instantiates rgcn_bwd_kernel with one bit of rgcn_ablate set, so the
// probe times the kernel that ships (its one walk: nodxb_walk and
// nodae_walk remove the dxB and the dae term of it). Every mode, full (0)
// included, is launched here, through one table of kernel
// instantiations, followed by the library's two datt reduction kernels
// (skipped by kNoDatt). Full is
// instantiated at every channel width, the other modes at those of the
// MUTAG path only (C = 2 and 9..16); anything else returns
// cudaErrorInvalidValue. Variants other than full are wrong on purpose.
// `smem` bytes of dynamic shared memory per block, which no variant uses,
// cap the walk's blocks per SM: the probe pads every mode alike so that
// none holds more blocks than full does (packed_rgcn_ablate_occupancy
// gives the count).
//
// Forward: depth 1 is the source's first design of the forward,
// rgcn_fwd_kernel (a warp per receiver row gathering each sender's xB
// row per edge), which the library's two-launch forward replaced. Depths
// 2 and 4 run rgcn_fwd_ahead_kernel below, which keeps that walk's lane
// tiling and sum order and issues the loads of later edges first; they
// must equal depth 1 bit for bit.

#include "../pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu"

namespace {

using BwdWalk = decltype(&rgcn_bwd_kernel<1, 0>);

template <int CP>
BwdWalk ablated(unsigned mode) {
  using namespace rgcn_ablate;
  // kNoDatt keeps the walk whole: it removes the reduction launches
#define PROBE_MODE(bit) \
  case bit:             \
    return rgcn_bwd_kernel<CP, (bit) & ~kNoDatt>;
  switch (mode) {
    PROBE_MODE(kNoIndex)
    PROBE_MODE(kNoXb)
    PROBE_MODE(kNoG)
    PROBE_MODE(kNoDxbWalk)
    PROBE_MODE(kNoDaeWalk)
    PROBE_MODE(kNoDaeStore)
    PROBE_MODE(kNoDxbStore)
    PROBE_MODE(kNoDatt)
    default:
      return nullptr;
  }
#undef PROBE_MODE
}

// The walk kernel of `mode` at the backward's channel width of C
// (with_bwd_width), or null.
BwdWalk bwd_walk(unsigned mode, int C) {
  BwdWalk walk = nullptr;
  if (C <= 0) return walk;
  with_bwd_width(C, [&](auto width) {
    constexpr int CP = decltype(width)::value;
    if (mode == 0) {
      walk = rgcn_bwd_kernel<CP, 0>;
    } else if constexpr (CP == 2 || CP == 16) {
      if (C <= 16) walk = ablated<CP>(mode);
    }
  });
  return walk;
}

// The forward's walk over one row with its loads issued ahead: the col,
// et and w of the next kDepth edges and the att and xB values of edge
// e + 1 are requested before edge e's multiply-adds, which keep the
// order of the first design's walk (edge after edge, bases in order), so
// the sum is the same bit for bit. Lane (cl, bl) holds channel c and the
// bases bl, bl + NB, ... in kSlots registers per array
// (B <= kSlots * 32 / CP).
template <int CP, int kDepth, int kSlots>
__device__ __forceinline__ float rgcn_fwd_walk_ahead(
    const int* __restrict__ col, const int* __restrict__ et,
    const float* __restrict__ w, const float* __restrict__ xB,
    const float* __restrict__ att, int e0, int e1, int bl, int c, int B,
    int C) {
  constexpr int NB = 32 / CP;
  const size_t BC = static_cast<size_t>(B) * C;
  float acc = 0.f;
  if (e0 >= e1) return acc;
  // ring[k]: col, et and w of edge e + 1 + k
  int rc[kDepth], rt[kDepth];
  float rw[kDepth];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const int e = e0 + 1 + k;
    rc[k] = e < e1 ? __ldg(col + e) : 0;
    rt[k] = e < e1 ? __ldg(et + e) : 0;
    rw[k] = e < e1 ? __ldg(w + e) : 0.f;
  }
  // the current edge's weight, att and xB values
  float cw = __ldg(w + e0);
  float ca[kSlots], cx[kSlots];
  {
    const float* ar = att + static_cast<size_t>(__ldg(et + e0)) * B;
    const float* xr = xB + static_cast<size_t>(__ldg(col + e0)) * BC + c;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = bl + j * NB;
      ca[j] = b < B ? __ldg(ar + b) : 0.f;
      cx[j] = b < B ? __ldg(xr + static_cast<size_t>(b) * C) : 0.f;
    }
  }
  for (int e = e0; e < e1; ++e) {
    // edge e + 1's att and xB (its indices are ring[0])
    const bool more = e + 1 < e1;
    float na[kSlots], nx[kSlots];
    const float* ar = att + static_cast<size_t>(rt[0]) * B;
    const float* xr = xB + static_cast<size_t>(rc[0]) * BC + c;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int b = bl + j * NB;
      na[j] = more && b < B ? __ldg(ar + b) : 0.f;
      nx[j] = more && b < B ? __ldg(xr + static_cast<size_t>(b) * C) : 0.f;
    }
    const float nw = rw[0];
    // shift the ring; request edge e + 1 + kDepth's indices
#pragma unroll
    for (int k = 0; k + 1 < kDepth; ++k) {
      rc[k] = rc[k + 1];
      rt[k] = rt[k + 1];
      rw[k] = rw[k + 1];
    }
    {
      const int ef = e + 1 + kDepth;
      rc[kDepth - 1] = ef < e1 ? __ldg(col + ef) : 0;
      rt[kDepth - 1] = ef < e1 ? __ldg(et + ef) : 0;
      rw[kDepth - 1] = ef < e1 ? __ldg(w + ef) : 0.f;
    }
    // edge e's multiply-adds, as the first design's walk does them
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (bl + j * NB < B) acc += (cw * ca[j]) * cx[j];
    }
    cw = nw;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      ca[j] = na[j];
      cx[j] = nx[j];
    }
  }
  return acc;
}

// The first design of the forward over the receiver-major CSR, at any
// width: depth 1.
int first_fwd(void* row_ptr, void* col, void* et, void* w, void* xB,
              void* att, void* out, int n_rows, int B, int C,
              cudaStream_t st) {
  with_channel_width(C, [&](auto width) {
    constexpr int CP = decltype(width)::value;
    rgcn_fwd_kernel<CP><<<blocks_for(n_rows), kThreads, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const int*>(et), static_cast<const float*>(w),
        static_cast<const float*>(xB), static_cast<const float*>(att),
        static_cast<float*>(out), n_rows, B, C);
  });
  return static_cast<int>(cudaGetLastError());
}

// rgcn_fwd_kernel with its walk replaced by rgcn_fwd_walk_ahead.
template <int CP, int kDepth, int kSlots>
__global__ void __launch_bounds__(kThreads)
rgcn_fwd_ahead_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col, const int* __restrict__ et,
                      const float* __restrict__ w,
                      const float* __restrict__ xB,
                      const float* __restrict__ att, float* __restrict__ out,
                      int n_rows, int B, int C) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int cl = lane % CP;
  const int bl = lane / CP;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  for (int c0 = 0; c0 < C; c0 += CP) {
    const int c = c0 + cl;
    const bool cok = c < C;
    float acc = 0.f;
    if (cok) {
      acc = rgcn_fwd_walk_ahead<CP, kDepth, kSlots>(col, et, w, xB, att, e0,
                                                    e1, bl, c, B, C);
    }
#pragma unroll
    for (int o = CP; o < 32; o <<= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (cok && bl == 0) out[static_cast<size_t>(row) * C + c] = acc;
  }
}

// The prefetching forward at channel width CP, holding kSlots bases per
// lane: just enough for the main path's shapes (C = 2: B <= 32; C = 16:
// B <= 32; C > 16: B <= 8).
template <int CP, int kDepth, int kSlots>
int pipe_fwd(void* row_ptr, void* col, void* et, void* w, void* xB,
             void* att, void* out, int n_rows, int B, int C,
             cudaStream_t st) {
  if (B > kSlots * (32 / CP)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rgcn_fwd_ahead_kernel<CP, kDepth, kSlots>
      <<<blocks_for(n_rows), kThreads, 0, st>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const int*>(et), static_cast<const float*>(w),
          static_cast<const float*>(xB), static_cast<const float*>(att),
          static_cast<float*>(out), n_rows, B, C);
  return static_cast<int>(cudaGetLastError());
}

template <int kDepth>
int pipe_fwd_at(void* row_ptr, void* col, void* et, void* w, void* xB,
                void* att, void* out, int n_rows, int B, int C,
                cudaStream_t st) {
  if (C == 2) {
    return pipe_fwd<2, kDepth, 2>(row_ptr, col, et, w, xB, att, out, n_rows,
                                  B, C, st);
  }
  if (C > 8 && C <= 16) {
    return pipe_fwd<16, kDepth, 16>(row_ptr, col, et, w, xB, att, out,
                                    n_rows, B, C, st);
  }
  if (C > 16) {
    return pipe_fwd<32, kDepth, 8>(row_ptr, col, et, w, xB, att, out,
                                   n_rows, B, C, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// packed_rgcn_bwd's arguments, then the mode (0 or one rgcn_ablate bit),
// the sink flag and the walk's dynamic shared memory per block, then the
// stream. The walk, then (unless kNoDatt) the two reduction launches,
// each checked.
extern "C" int packed_rgcn_ablate_bwd(void* row_ptr, void* col, void* et,
                                      void* w, void* pos, void* rel_ptr,
                                      void* xB, void* att, void* g,
                                      void* dxB, void* datt, void* dae,
                                      void* partial, int n_rows, int R,
                                      int B, int C, int splits,
                                      unsigned mode, int sink, int smem,
                                      void* stream) {
  const BwdWalk walk = bwd_walk(mode, C);
  if (walk == nullptr || B <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    walk<<<blocks_for(n_rows), kThreads, smem, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const int*>(et), static_cast<const float*>(w),
        static_cast<const int*>(pos), static_cast<const float*>(xB),
        static_cast<const float*>(att), static_cast<const float*>(g),
        static_cast<float*>(dxB), static_cast<float*>(dae), n_rows, B, C,
        bwd_vec(C, xB, g, dxB), sink);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (R > 0 && !(mode & rgcn_ablate::kNoDatt)) {
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

// Blocks per SM of the walk kernel of (mode, C) launched with `smem`
// bytes of dynamic shared memory, into *blocks. Call it before launching
// with that smem: above 48 KB it also raises the kernel's limit.
extern "C" int packed_rgcn_ablate_occupancy(unsigned mode, int C, int smem,
                                            int* blocks) {
  const BwdWalk walk = bwd_walk(mode, C);
  if (walk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, walk, kThreads, smem));
}

// The receiver-major CSR (row_ptr, col = sender, et, w), xB, att, out,
// n_rows, B, C, then the prefetch depth (1, 2 or 4), then the stream.
extern "C" int packed_rgcn_pipe_fwd(void* row_ptr, void* col, void* et,
                                    void* w, void* xB, void* att, void* out,
                                    int n_rows, int B, int C, int depth,
                                    void* stream) {
  if (n_rows <= 0 || B <= 0 || C <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth == 1) {
    return first_fwd(row_ptr, col, et, w, xB, att, out, n_rows, B, C, st);
  }
  if (depth == 2) {
    return pipe_fwd_at<2>(row_ptr, col, et, w, xB, att, out, n_rows, B, C,
                          st);
  }
  if (depth == 4) {
    return pipe_fwd_at<4>(row_ptr, col, et, w, xB, att, out, n_rows, B, C,
                          st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
