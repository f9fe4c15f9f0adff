// Design probe of the packed-RGCN forward and backward
// (pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu), built and timed by
// probes/packed_rgcn_designs.py. Not part of the port.
//
// Forward: the library's packed_rgcn_fwd walks the sender-major CSR once
// for each edge's message (each xB row read once) and sums the messages
// per receiver with the segment sum. first_packed_rgcn_fwd launches the
// source's first design, rgcn_fwd_kernel (a warp per receiver row that
// gathers each sender's xB row per edge), at every width, over the
// receiver-major CSR: row_ptr, col (sender), et, w, xB, att, out, n_rows,
// B, C, stream.
//
// The production source is included: its backward walks a sender row's
// edges once for both terms, one lane per basis, each edge's indices and
// g row loaded once, the g rows of a batch of 32 edges staged in shared
// memory (rgcn_bwd_kernel). Beside it, in namespace
// first_design, the source's first design of the walk, as it was without
// its ablation hooks: the lanes tile (basis, channel) as the forward's
// do, and the warp walks the row's edges once per kSteps basis steps for
// dxB and once more, one lane per basis, for dae, loading each edge's col,
// et and w and its g row on every walk. first_packed_rgcn_bwd launches it,
// then the library's two datt kernels, with packed_rgcn_bwd's signature,
// so one run times both designs on the same inputs, and nvcc's -Xptxas -v
// report of this source gives the registers and spills of both.
// blocks_packed_rgcn_bwd launches the library's walk with another floor
// of blocks per SM (which caps its registers); packed_rgcn_datt the datt
// reduction alone, which reads back the dae scratch.

#include "../pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu"

namespace {
namespace first_design {

// Basis steps of the dxB row that the backward keeps in registers.
constexpr int kSteps = 8;

// Backward: warp = sender row of the sender-major CSR; col = receiver,
// pos = the edge's position in relation-major order. Writes dxB
// (n_rows, B*C) and dae (E, B) in relation-major order.
template <int CP>
__global__ void __launch_bounds__(kThreads)
rgcn_bwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const int* __restrict__ et, const float* __restrict__ w,
                const int* __restrict__ pos, const float* __restrict__ xB,
                const float* __restrict__ att, const float* __restrict__ g,
                float* __restrict__ dxB, float* __restrict__ dae, int n_rows,
                int B, int C) {
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
  for (int c0 = 0; c0 < C; c0 += CP) {
    const int c = c0 + cl;
    const bool cok = c < C;
    for (int b0 = 0; b0 < B; b0 += NB * kSteps) {
      float acc[kSteps];
#pragma unroll
      for (int k = 0; k < kSteps; ++k) acc[k] = 0.f;
      if (cok) {
        for (int e = e0; e < e1; ++e) {
          const float gv =
              __ldg(w + e) * __ldg(g + static_cast<size_t>(__ldg(col + e)) *
                                           C +
                                   c);
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
          if (b < B) drow[static_cast<size_t>(b) * C + c] = acc[k];
        }
      }
    }
  }
  // dae[e, b] = w * <xB[row, b, :], g[dst, :]>: one lane per basis, so an
  // edge's B values leave in one store; every lane reads the same g
  // element at a time. Narrow C keeps the lane's slice of the row in
  // registers.
  for (int b = lane; b < B; b += 32) {
    const float* xb = xrow + static_cast<size_t>(b) * C;
    float xs[CP <= 16 ? CP : 1];
    if constexpr (CP <= 16) {
#pragma unroll
      for (int c = 0; c < CP; ++c) xs[c] = c < C ? __ldg(xb + c) : 0.f;
    }
    for (int e = e0; e < e1; ++e) {
      const float* gr = g + static_cast<size_t>(__ldg(col + e)) * C;
      float dot = 0.f;
      if constexpr (CP <= 16) {
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          if (c < C) dot += xs[c] * __ldg(gr + c);
        }
      } else {
        for (int c = 0; c < C; ++c) dot += __ldg(xb + c) * __ldg(gr + c);
      }
      dae[static_cast<size_t>(__ldg(pos + e)) * B + b] = __ldg(w + e) * dot;
    }
  }
}

}  // namespace first_design

// The datt reduction of packed_rgcn_bwd: its two launches, each checked.
int datt(void* rel_ptr, void* dae, void* partial, void* datt_out, int R,
         int B, int splits, cudaStream_t st) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  rgcn_datt_partial_kernel<<<dim3(splits, R), kThreads, 0, st>>>(
      static_cast<const int*>(rel_ptr), static_cast<const float*>(dae),
      static_cast<float*>(partial), B, splits);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rgcn_datt_final_kernel<<<(R * B + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(static_cast<const float*>(partial),
                                 static_cast<float*>(datt_out), R, B, splits);
  return static_cast<int>(cudaGetLastError());
}

// The library's walk with at least MB blocks of it per SM.
template <int MB>
void blocks_walk(void* row_ptr, void* col, void* et, void* w, void* pos,
                 void* xB, void* att, void* g, void* dxB, void* dae,
                 int n_rows, int B, int C, cudaStream_t st) {
  with_bwd_width(C, [&](auto width) {
    constexpr int CP = decltype(width)::value;
    rgcn_bwd_kernel<CP, 0, MB><<<blocks_for(n_rows), kThreads, 0, st>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const int*>(et), static_cast<const float*>(w),
        static_cast<const int*>(pos), static_cast<const float*>(xB),
        static_cast<const float*>(att), static_cast<const float*>(g),
        static_cast<float*>(dxB), static_cast<float*>(dae), n_rows, B, C,
        bwd_vec(C, xB, g, dxB), 0);
  });
}

}  // namespace

// The forward's first design over the receiver-major CSR.
extern "C" int first_packed_rgcn_fwd(void* row_ptr, void* col, void* et,
                                     void* w, void* xB, void* att, void* out,
                                     int n_rows, int B, int C,
                                     void* stream) {
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

// packed_rgcn_bwd with the first design's walk.
extern "C" int first_packed_rgcn_bwd(void* row_ptr, void* col, void* et,
                                     void* w, void* pos, void* rel_ptr,
                                     void* xB, void* att, void* g, void* dxB,
                                     void* datt_out, void* dae,
                                     void* partial, int n_rows, int R, int B,
                                     int C, int splits, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    with_channel_width(C, [&](auto width) {
      constexpr int CP = decltype(width)::value;
      first_design::rgcn_bwd_kernel<CP>
          <<<blocks_for(n_rows), kThreads, 0, st>>>(
              static_cast<const int*>(row_ptr), static_cast<const int*>(col),
              static_cast<const int*>(et), static_cast<const float*>(w),
              static_cast<const int*>(pos), static_cast<const float*>(xB),
              static_cast<const float*>(att), static_cast<const float*>(g),
              static_cast<float*>(dxB), static_cast<float*>(dae), n_rows, B,
              C);
    });
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return datt(rel_ptr, dae, partial, datt_out, R, B, splits, st);
}

// packed_rgcn_bwd with the library's walk at least `blocks` (1, 3, 4 or
// 5) blocks of it per SM, then the stream.
extern "C" int blocks_packed_rgcn_bwd(void* row_ptr, void* col, void* et,
                                      void* w, void* pos, void* rel_ptr,
                                      void* xB, void* att, void* g,
                                      void* dxB, void* datt_out, void* dae,
                                      void* partial, int n_rows, int R,
                                      int B, int C, int splits, int blocks,
                                      void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    const auto walk = blocks == 1   ? blocks_walk<1>
                      : blocks == 3 ? blocks_walk<3>
                      : blocks == 4 ? blocks_walk<4>
                      : blocks == 5 ? blocks_walk<5>
                                    : nullptr;
    if (walk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    walk(row_ptr, col, et, w, pos, xB, att, g, dxB, dae, n_rows, B, C, st);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return datt(rel_ptr, dae, partial, datt_out, R, B, splits, st);
}

// The datt reduction alone over a dae already written: rel_ptr, dae,
// partial, datt, R, B, splits, stream.
extern "C" int packed_rgcn_datt(void* rel_ptr, void* dae, void* partial,
                                void* datt_out, int R, int B, int splits,
                                void* stream) {
  return datt(rel_ptr, dae, partial, datt_out, R, B, splits,
              static_cast<cudaStream_t>(stream));
}
