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
// Forward: depth 1 is the library's forward itself (packed_rgcn_fwd: the
// message walk rgcn_msg_kernel over the sender-major CSR, then the
// segment sum). Depths 2 and 4 run rgcn_msg_ahead_kernel below, that walk
// with the loads of later rows issued first: before a row's multiply-adds
// it requests the xB slice and the first batch of (et, w, pos) of the
// item (a row and a pass of channels) D - 1 ahead in the grid-stride
// order, into a ring of D register sets.
// The sums keep the library's order and expressions, and the segment sum
// follows, so every depth gives the library's bits.

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

// One item of the message walk (a row and a pass of CP channels), as
// rgcn_msg_kernel holds it before its multiply-adds: the row's edge
// range, this lane's KS bases of the row's xB slice, and the et, w and
// pos of the first batch of edges, one edge a lane.
template <int KS>
struct MsgItem {
  int row, c0, e0, e1;
  float xs[KS];
  int et, pos;
  float w;
};

// Requests item `item` of this group's walk (row row0 + (item / passes)
// stride, channel pass item % passes): its loads are issued here and used
// when the item's turn comes. Past the last row it loads nothing.
template <int CP, int LR, int KS>
__device__ __forceinline__ void msg_request(
    MsgItem<KS>& it, int item, int row0, int stride, int passes,
    const int* __restrict__ row_ptr, const int* __restrict__ et,
    const float* __restrict__ w, const int* __restrict__ pos,
    const float* __restrict__ xB, int n_rows, int B, int C, int lane) {
  constexpr int NB = LR / CP;
  const int cl = lane % CP;
  const int bl = lane / CP;
  it.row = row0 + (item / passes) * stride;
  it.c0 = (item % passes) * CP;
  it.e0 = 0;
  it.e1 = 0;
  if (it.row < n_rows) {
    it.e0 = __ldg(row_ptr + it.row);
    it.e1 = __ldg(row_ptr + it.row + 1);
  }
  const bool live = it.e0 < it.e1;
  const int c = it.c0 + cl;
  const bool cok = c < C;
  const float* xrow = xB + static_cast<size_t>(it.row) * B * C;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int b = bl + j * NB;
    it.xs[j] = live && cok && b < B
                   ? __ldg(xrow + static_cast<size_t>(b) * C + c)
                   : 0.f;
  }
  const int me = it.e0 + lane;
  it.et = 0;
  it.pos = 0;
  it.w = 0.f;
  if (me < it.e1) {
    it.et = __ldg(et + me);
    it.w = __ldg(w + me);
    it.pos = __ldg(pos + me);
  }
}

// The multiply-adds and stores of one item, as rgcn_msg_kernel does them
// (the same expressions in the same order); batches after the first load
// their indices here.
template <int CP, int LR, int KS>
__device__ __forceinline__ void msg_walk(
    const MsgItem<KS>& it, const Row<LR>& grp, const float* att_s,
    const int* __restrict__ et, const float* __restrict__ w,
    const int* __restrict__ pos, const float* __restrict__ xB,
    float* __restrict__ msg, int B, int C) {
  constexpr int NB = LR / CP;
  const int lane = grp.lane;
  const int cl = lane % CP;
  const int bl = lane / CP;
  const int c = it.c0 + cl;
  const bool cok = c < C;
  const float* xrow = xB + static_cast<size_t>(it.row) * B * C;
  for (int eb = it.e0; eb < it.e1; eb += LR) {
    int my_et = it.et, my_pos = it.pos;
    float my_w = it.w;
    if (eb != it.e0) {
      const int me = eb + lane;
      my_et = 0;
      my_pos = 0;
      my_w = 0.f;
      if (me < it.e1) {
        my_et = __ldg(et + me);
        my_w = __ldg(w + me);
        my_pos = __ldg(pos + me);
      }
    }
    const int ne = min(LR, it.e1 - eb);
#pragma unroll 2
    for (int k = 0; k < ne; ++k) {
      const int t = grp.bcast(my_et, k);
      const float wk = __shfl_sync(grp.mask, my_w, k, LR);
      const int pk = grp.bcast(my_pos, k);
      const int ar = t * B;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int b = bl + j * NB;
        if (b < B) part += att_s[ar + b] * it.xs[j];
      }
      for (int b = bl + KS * NB; b < B; b += NB) {   // past the slots
        part += att_s[ar + b] * (cok ? __ldg(xrow + static_cast<size_t>(b)
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

// rgcn_msg_kernel (att in shared memory) with its loads kDepth - 1 items
// ahead: the ring holds kDepth items, and before an item's multiply-adds
// the group requests the item kDepth - 1 after it into the slot the
// previous item freed (the loop is unrolled kDepth times, so every slot
// is a register set).
template <int CP, int G, int kDepth>
__global__ void __launch_bounds__(kThreads, kMsgMinBlocks)
rgcn_msg_ahead_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ et, const float* __restrict__ w,
                      const int* __restrict__ pos,
                      const float* __restrict__ xB,
                      const float* __restrict__ att, float* __restrict__ msg,
                      int n_rows, int R, int B, int C) {
  constexpr int LR = 32 / G;
  constexpr int KS = kMsgSlots;
  static_assert(LR / CP >= 1, "a row's lanes hold at least its CP channels");
  extern __shared__ float att_s[];
  for (int k = threadIdx.x; k < R * B; k += kThreads) {
    att_s[k] = __ldg(att + k);
  }
  __syncthreads();
  const Row<LR> grp;
  const int row0 = blockIdx.x * (kThreads / LR) + threadIdx.x / LR;
  const int stride = gridDim.x * (kThreads / LR);
  const int passes = (C + CP - 1) / CP;
  MsgItem<KS> ring[kDepth];
#pragma unroll
  for (int s = 0; s + 1 < kDepth; ++s) {
    msg_request<CP, LR, KS>(ring[s], s, row0, stride, passes, row_ptr, et,
                            w, pos, xB, n_rows, B, C, grp.lane);
  }
  for (int i = 0;; i += kDepth) {
#pragma unroll
    for (int s = 0; s < kDepth; ++s) {
      msg_request<CP, LR, KS>(ring[(s + kDepth - 1) % kDepth],
                              i + s + kDepth - 1, row0, stride, passes,
                              row_ptr, et, w, pos, xB, n_rows, B, C,
                              grp.lane);
      if (ring[s].row >= n_rows) return;  // rows only grow along the walk
      msg_walk<CP, LR, KS>(ring[s], grp, att_s, et, w, pos, xB, msg, B, C);
    }
  }
}

// Launch 1 of the forward at depth kDepth (2 or 4) with the library's
// grid and shared memory: the widths of the main path's shapes only (C =
// 2 at two lanes a channel, 9 to 16, and over 16 at one lane a channel)
// and att in shared memory; anything else is cudaErrorInvalidValue.
template <int kDepth>
int msg_ahead(const int* send_ptr, const int* send_et, const float* send_w,
              const int* fwd_pos, const float* xB, const float* att,
              float* msg, int n_send, int R, int B, int C,
              cudaStream_t st) {
  if (R * B > kAttSmemFloats || !(C == 2 || C > 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * R * B;
  with_channel_width(C, [&](auto width) {
    constexpr int CP = decltype(width)::value;
    if constexpr (CP == 2 || CP >= 16) {
      constexpr int G = msg_rows_per_warp(CP);
      rgcn_msg_ahead_kernel<CP, G, kDepth>
          <<<msg_blocks(n_send, G), kThreads, smem, st>>>(
              send_ptr, send_et, send_w, fwd_pos, xB, att, msg, n_send, R,
              B, C);
    }
  });
  return static_cast<int>(cudaGetLastError());
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

// packed_rgcn_fwd's arguments, then the prefetch depth (1, 2 or 4), then
// the stream. Depth 1 is packed_rgcn_fwd itself; depths 2 and 4 run the
// message walk with its loads ahead, then the same segment sum.
extern "C" int packed_rgcn_pipe_fwd(void* row_ptr, void* send_ptr,
                                    void* send_et, void* send_w,
                                    void* fwd_pos, void* xB, void* att,
                                    void* msg, void* out, int n_rows,
                                    int n_send, int R, int B, int C,
                                    int depth, void* stream) {
  if (depth == 1) {
    return packed_rgcn_fwd(row_ptr, send_ptr, send_et, send_w, fwd_pos, xB,
                           att, msg, out, n_rows, n_send, R, B, C, stream);
  }
  if (depth != 2 && depth != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows <= 0 || B <= 0 || C <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_send > 0) {
    const auto ahead = depth == 2 ? msg_ahead<2> : msg_ahead<4>;
    const int rc = ahead(
        static_cast<const int*>(send_ptr), static_cast<const int*>(send_et),
        static_cast<const float*>(send_w), static_cast<const int*>(fwd_pos),
        static_cast<const float*>(xB), static_cast<const float*>(att),
        static_cast<float*>(msg), n_send, R, B, C, st);
    if (rc != 0) return rc;
  }
  segment_sum::dispatch(static_cast<const int*>(row_ptr),
                        static_cast<const float*>(msg),
                        static_cast<float*>(out), n_rows, C, st);
  return static_cast<int>(cudaGetLastError());
}
