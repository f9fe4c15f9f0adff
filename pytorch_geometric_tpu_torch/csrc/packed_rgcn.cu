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
// The forward gathers a whole xB row (B*C floats) per edge, which is more
// traffic than the bound counts wherever a source row has more than one
// out-edge and misses the L2.
//
// Design:
// - One warp owns one CSR row. Its lanes tile (basis, channel): with CP
//   the smallest power of two >= min(C, 32), lane l holds channel l % CP
//   and the bases l / CP, l / CP + 32 / CP, ... So at C = 16 a warp reads
//   32 neighbouring floats of the row per step (two bases), and at C = 2
//   sixteen bases per step: narrow C splits the bases over the lanes, not
//   the channels. C > 32 is walked in chunks of 32 channels.
// - Forward (receiver-major CSR): each lane sums its share over the row's
//   edges and bases, a butterfly of shuffles adds the lanes of one
//   channel, and out[row] is written once.
// - Backward (sender-major CSR): the xB row that datt needs is the
//   sender's own, so the warp reads it once per row, not once per edge.
//   It walks the row's edges twice. First for dxB, with the forward's
//   lane tiling and kSteps basis steps of the output row in registers:
//   dxB[row] is written once. Then for dae[e, b] = w * <xB[src, b, :],
//   g[dst, :]> with one lane per basis: the lane keeps its C values of
//   the row in registers (C <= 16) and an edge's B values leave in one
//   store.
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
//   warp: right, and the tail of the launch. Splitting hub rows is left
//   for a graph that has them, with a measurement.
// - fp32 throughout, no fast-math flags.
//
// Ablation hooks: the backward kernel takes a bit mask kAblate of terms
// to remove (namespace rgcn_ablate) and a run-time flag `sink`. The
// library instantiates kAblate = 0 only; probes/packed_rgcn_ablate.cu
// includes this file and instantiates the others, so a probe times the
// kernel that ships. A removed load is replaced by a value loaded once per
// row, and a removed store is kept behind `if (sink)` (sink = 0 at run
// time), so that nvcc cannot delete the work that feeds it.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/packed_rgcn.py); each launch goes on
// the caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Basis steps of the dxB row that the backward keeps in registers.
constexpr int kSteps = 8;
constexpr unsigned kFull = 0xffffffffu;

// Terms of the backward that an ablation removes, one bit each.
namespace rgcn_ablate {
constexpr unsigned kNoIndex = 1u << 0;     // col[e]: the row itself
constexpr unsigned kNoXb = 1u << 1;        // the row's xB slice: att[b]
constexpr unsigned kNoG = 1u << 2;         // g[col]: the row's own xB
constexpr unsigned kNoDxbWalk = 1u << 3;   // no first walk (dxB)
constexpr unsigned kNoDaeWalk = 1u << 4;   // no second walk (dae)
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

// Backward: warp = sender row of the sender-major CSR; col = receiver,
// pos = the edge's position in relation-major order. Writes dxB
// (n_rows, B*C) and dae (E, B) in relation-major order. kAblate and sink:
// see the header (0 and 0 in the library; kNoIndex needs every row with
// edges to be a row of g, as a sender of a node graph is).
template <int CP, unsigned kAblate = 0>
__global__ void __launch_bounds__(kThreads)
rgcn_bwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const int* __restrict__ et, const float* __restrict__ w,
                const int* __restrict__ pos, const float* __restrict__ xB,
                const float* __restrict__ att, const float* __restrict__ g,
                float* __restrict__ dxB, float* __restrict__ dae, int n_rows,
                int B, int C, int sink) {
  using namespace rgcn_ablate;
  static_assert(kAblate == 0 || CP <= 16,
                "ablations are instantiated for C <= 16 only");
  static_assert(!(kAblate & kNoDatt),
                "kNoDatt removes the datt launches, not a term of this walk");
  constexpr bool kIndex = !(kAblate & kNoIndex);
  constexpr bool kG = !(kAblate & kNoG);
  constexpr int NB = 32 / CP;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int cl = lane % CP;
  const int bl = lane / CP;
  const size_t BC = static_cast<size_t>(B) * C;
  const int e0 = row_ptr[row];
  const int e1 = row_ptr[row + 1];
  const float* xrow = xB + static_cast<size_t>(row) * BC;
  float* drow = dxB + static_cast<size_t>(row) * BC;
  // dxB[row]: lanes tile (basis, channel); kSteps basis steps at a time
  // stay in registers while the row's edges are walked.
  if constexpr (!(kAblate & kNoDxbWalk)) {
    const bool stores = !(kAblate & kNoDxbStore) || sink != 0;
    for (int c0 = 0; c0 < C; c0 += CP) {
      const int c = c0 + cl;
      const bool cok = c < C;
      // stand-in for g[col] (kNoG): the row's own xB value
      float g_own = 0.f;
      if constexpr (!kG) g_own = cok ? __ldg(xrow + c) : 0.f;
      for (int b0 = 0; b0 < B; b0 += NB * kSteps) {
        float acc[kSteps];
#pragma unroll
        for (int k = 0; k < kSteps; ++k) acc[k] = 0.f;
        if (cok) {
          for (int e = e0; e < e1; ++e) {
            // one expression, as the library's walk had it: the order of
            // its loads is the compiled code's
            const float gv =
                __ldg(w + e) *
                (kG ? __ldg(g +
                            static_cast<size_t>(kIndex ? __ldg(col + e) : row) *
                                C +
                            c)
                    : g_own);
            const float* ar = att + static_cast<size_t>(__ldg(et + e)) * B;
#pragma unroll
            for (int k = 0; k < kSteps; ++k) {
              const int b = b0 + k * NB + bl;
              if (b < B) acc[k] += __ldg(ar + b) * gv;
            }
          }
#pragma unroll
          for (int k = 0; k < kSteps; ++k) {
            const int b = b0 + k * NB + bl;
            if (b < B && stores) drow[static_cast<size_t>(b) * C + c] = acc[k];
          }
        }
      }
    }
  }
  // dae[e, b] = w * <xB[row, b, :], g[dst, :]>: one lane per basis, so an
  // edge's B values leave in one store; every lane reads the same g
  // element at a time. Narrow C keeps the lane's slice of the row in
  // registers.
  if constexpr (!(kAblate & kNoDaeWalk)) {
    const bool stores = !(kAblate & kNoDaeStore) || sink != 0;
    for (int b = lane; b < B; b += 32) {
      const float* xb = xrow + static_cast<size_t>(b) * C;
      float xs[CP <= 16 ? CP : 1];
      if constexpr (CP <= 16) {
        // stand-in for the row's slice (kNoXb): att[0, b] and the channel
        const float a = (kAblate & kNoXb) ? __ldg(att + b) : 0.f;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          xs[c] = c < C ? ((kAblate & kNoXb) ? a + c : __ldg(xb + c)) : 0.f;
        }
      }
      for (int e = e0; e < e1; ++e) {
        const int dst = kIndex ? __ldg(col + e) : row;
        const float* gr = g + static_cast<size_t>(dst) * C;
        float dot = 0.f;
        if constexpr (CP <= 16) {
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            if (c < C) dot += xs[c] * (kG ? __ldg(gr + c) : xs[c]);
          }
        } else {
          for (int c = 0; c < C; ++c) dot += __ldg(xb + c) * __ldg(gr + c);
        }
        if (stores) {
          dae[static_cast<size_t>(__ldg(pos + e)) * B + b] = __ldg(w + e) * dot;
        }
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

}  // namespace

// Forward over the receiver-major CSR (col = sender, et and w in CSR
// order): out (n_rows, C). One launch.
extern "C" int packed_rgcn_fwd(void* row_ptr, void* col, void* et, void* w,
                               void* xB, void* att, void* out, int n_rows,
                               int B, int C, void* stream) {
  if (n_rows > 0 && B > 0 && C > 0) {
    with_channel_width(C, [&](auto width) {
      constexpr int CP = decltype(width)::value;
      rgcn_fwd_kernel<CP><<<blocks_for(n_rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const int*>(et), static_cast<const float*>(w),
          static_cast<const float*>(xB), static_cast<const float*>(att),
          static_cast<float*>(out), n_rows, B, C);
    });
  }
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
    with_channel_width(C, [&](auto width) {
      constexpr int CP = decltype(width)::value;
      rgcn_bwd_kernel<CP><<<blocks_for(n_rows), kThreads, 0, st>>>(
          static_cast<const int*>(row_ptr), static_cast<const int*>(col),
          static_cast<const int*>(et), static_cast<const float*>(w),
          static_cast<const int*>(pos), static_cast<const float*>(xB),
          static_cast<const float*>(att), static_cast<const float*>(g),
          static_cast<float*>(dxB), static_cast<float*>(dae), n_rows, B, C,
          0);
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
