// Term-by-term ablation of the packed-GAT backward kernel
// (pytorch_geometric_tpu_torch/csrc/packed_gat.cu, gat_bwd_kernel).
//
// Counterpart of the Pallas probe tools/gat_ablate.py (make_kernel), which
// copied the TPU backward and removed one TPU cost term per variant
// (one-hot builds, gathers, the hi/lo bf16 split, scatters). Here the
// production source is included, and each variant instantiates its kernel
// template with one bit of gat_ablate set, so the probe times the kernel
// that ships and cannot drift from it. Every variant but full is wrong on
// purpose; only its time matters. probes/gat_ablate.py drives it.
//
// One walk per call (src_side 0: the receiver-major CSR, dd; 1: the
// sender-major CSR, ds and dh), as the library's packed_gat_bwd. Every
// mode, full (0) included, is launched here, through one table of kernel
// instantiations, at the group width of the main path's C (5..8 channels,
// G = 8) only, to keep the build short; any other C or an unknown mode
// returns cudaErrorInvalidValue. sink = 0 keeps the stores that kNoStore
// removes behind a run-time test. `smem` bytes of dynamic shared memory
// per block, which no variant uses, cap the blocks per SM: the probe pads
// every mode alike so that none holds more blocks than full does
// (packed_gat_ablate_occupancy gives the count).

#include "../pytorch_geometric_tpu_torch/csrc/packed_gat.cu"

namespace {

constexpr int kGroup = 8;
using BwdWalk = decltype(&gat_bwd_kernel<kGroup, false, 0>);

template <bool kSrc>
BwdWalk walk_of(unsigned mode) {
  using namespace gat_ablate;
#define PROBE_MODE(bit) \
  case bit:             \
    return gat_bwd_kernel<kGroup, kSrc, bit>;
  switch (mode) {
    case 0:
      return gat_bwd_kernel<kGroup, kSrc, 0>;
    PROBE_MODE(kNoIndex)
    PROBE_MODE(kNoGatherS)
    PROBE_MODE(kNoGatherG)
    PROBE_MODE(kNoGatherH)
    PROBE_MODE(kNoExp)
    PROBE_MODE(kNoDrop)
    PROBE_MODE(kNoShuffle)
    PROBE_MODE(kNoStore)
    default:
      return nullptr;
  }
#undef PROBE_MODE
}

// The walk kernel of `mode` on side src_side at channel count C, or null.
BwdWalk bwd_walk(unsigned mode, int src_side, int C) {
  if (C <= 4 || C > 8) return nullptr;
  return src_side ? walk_of<true>(mode) : walk_of<false>(mode);
}

}  // namespace

// packed_gat_bwd's arguments, then the mode (0 or one gat_ablate bit),
// the sink flag and the dynamic shared memory per block, then the stream.
extern "C" int packed_gat_ablate_bwd(void* row_ptr, void* col, void* eid,
                                     void* d, void* s, void* h, void* m,
                                     void* g, void* seed, void* out_h,
                                     void* dh, int n_rows, int H, int C,
                                     unsigned thresh, float scale,
                                     float slope, int src_side,
                                     unsigned mode, int sink, int smem,
                                     void* stream) {
  const BwdWalk walk = bwd_walk(mode, src_side, C);
  if (walk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  walk<<<blocks_for(n_rows, H, kGroup), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const int*>(eid), static_cast<const float*>(d),
      static_cast<const float*>(s), static_cast<const float*>(h),
      static_cast<const float*>(m), static_cast<const float*>(g),
      static_cast<const int*>(seed), static_cast<float*>(out_h),
      static_cast<float*>(dh), n_rows, H, C, thresh, scale, slope, sink);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM of the walk kernel of (mode, src_side, C) launched with
// `smem` bytes of dynamic shared memory, into *blocks. Call it before
// launching with that smem: above 48 KB it also raises the kernel's limit.
extern "C" int packed_gat_ablate_occupancy(unsigned mode, int src_side,
                                           int C, int smem, int* blocks) {
  const BwdWalk walk = bwd_walk(mode, src_side, C);
  if (walk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, walk, kThreads, smem));
}
