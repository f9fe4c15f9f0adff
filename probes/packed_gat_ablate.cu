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
// instantiations, at the lane map the library picks for the call
// (with_bwd_lanes), for the lane maps of the main path's widths only, to
// keep the build short: (8, 8) at 16 and 32 lanes a row (float4 loads),
// one head of 5..8 channels at 8 and 16 lanes (one float at a time). A
// call at any other lane map, or at a width the library runs on
// its first design, or an unknown mode returns cudaErrorInvalidValue.
// sink = 0 keeps the stores that kNoStore removes behind a run-time test.
// `smem` bytes of dynamic shared memory per block, which no variant uses,
// cap the blocks per SM: the probe pads every mode alike so that none
// holds more blocks than full does (packed_gat_ablate_occupancy gives the
// count).

#include "../pytorch_geometric_tpu_torch/csrc/packed_gat.cu"

namespace {

// The lane maps (L, V, KC) that the probe instantiates.
template <int L, int V, int KC>
constexpr bool kProbed =
    KC == 8 &&
    ((V == 4 && (L == 16 || L == 32)) || (V == 1 && (L == 8 || L == 16)));

// Blocks per SM of gat_bwd_kernel<L, V, KC, src_side, kMode> launched with
// `smem` bytes of dynamic shared memory (above 48 KB it also raises the
// kernel's limit).
template <int L, int V, int KC, unsigned kMode>
int occupancy(int src_side, int smem, int* blocks) {
  const void* kernel =
      src_side ? reinterpret_cast<const void*>(
                     gat_bwd_kernel<L, V, KC, true, kMode>)
               : reinterpret_cast<const void*>(
                     gat_bwd_kernel<L, V, KC, false, kMode>);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, smem));
}

// A mode's walk at one lane map: its launch and its occupancy.
struct ProbeWalk {
  int (*launch)(const BwdArgs&, int, int, int, cudaStream_t);
  int (*occupancy)(int, int, int*);
};

template <int L, int V, int KC, unsigned kMode>
ProbeWalk probe_walk() {
  return ProbeWalk{launch_bwd<L, V, KC, kMode>, occupancy<L, V, KC, kMode>};
}

template <int L, int V, int KC>
ProbeWalk walk_of(unsigned mode) {
  using namespace gat_ablate;
#define PROBE_MODE(bit) \
  case bit:             \
    return probe_walk<L, V, KC, bit>();
  switch (mode) {
    case 0:
      return probe_walk<L, V, KC, 0>();
    PROBE_MODE(kNoIndex)
    PROBE_MODE(kNoGatherS)
    PROBE_MODE(kNoGatherG)
    PROBE_MODE(kNoGatherH)
    PROBE_MODE(kNoExp)
    PROBE_MODE(kNoDrop)
    PROBE_MODE(kNoShuffle)
    PROBE_MODE(kNoStore)
    default:
      return ProbeWalk{nullptr, nullptr};
  }
#undef PROBE_MODE
}

// The walk of `mode` at the lane map the library picks for a; null
// members where the probe has none.
ProbeWalk bwd_walk(const BwdArgs& a, unsigned mode) {
  ProbeWalk walk{nullptr, nullptr};
  with_bwd_lanes(a, [&](auto lanes, auto vec, auto kc) {
    constexpr int L = decltype(lanes)::value;
    constexpr int V = decltype(vec)::value;
    constexpr int KC = decltype(kc)::value;
    if constexpr (kProbed<L, V, KC>) walk = walk_of<L, V, KC>(mode);
  });
  return walk;
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
  if (H <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const BwdArgs a = bwd_args(row_ptr, col, eid, d, s, h, m, g, seed, out_h,
                             dh, n_rows, H, C, thresh, scale, slope);
  const ProbeWalk walk = bwd_walk(a, mode);
  if (walk.launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return walk.launch(a, src_side, sink, smem,
                     static_cast<cudaStream_t>(stream));
}

// Blocks per SM of the walk kernel of (mode, src_side) at the lane map of
// n_rows rows of (H, C) (16-byte aligned) launched with `smem` bytes of
// dynamic shared memory, into *blocks. Call it before launching with that
// smem: above 48 KB it also raises the kernel's limit.
extern "C" int packed_gat_ablate_occupancy(unsigned mode, int src_side,
                                           int n_rows, int H, int C,
                                           int smem, int* blocks) {
  if (n_rows <= 0 || H <= 0 || C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = bwd_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, n_rows, H, C, 0u, 1.f, 0.2f);
  const ProbeWalk walk = bwd_walk(a, mode);
  if (walk.occupancy == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return walk.occupancy(src_side, smem, blocks);
}
