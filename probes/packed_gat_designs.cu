// Design probe of the packed-GAT forward and backward
// (pytorch_geometric_tpu_torch/csrc/packed_gat.cu), built and timed by
// probes/packed_gat_designs.py. Not part of the port.
//
// The production source is included. Its forward and backward each have
// three lane maps: the row map (gat_fwd_rows_kernel, gat_bwd_kernel: one
// sub-warp per CSR row over all heads, each edge's index and terms loaded
// once, whole-row gathers) for heads of at most 32 channels; the
// wide-head map (gat_fwd_wide_kernel, gat_bwd_wide_kernel: a warp per
// (row, head) across the head's channels, the row's edges 32 at a time, a
// lane each) past them; and the first design (one group of lanes per
// (row, head) walking the row's edges one after another), which the
// library keeps for the backward's narrow widths the row map leaves. The
// first design's forward, gat_fwd_kernel, runs at no width in the library
// and lives here, in namespace first_design, as it was there.
// first_packed_gat_fwd and first_packed_gat_bwd launch the first design,
// and wide_packed_gat_fwd and wide_packed_gat_bwd the wide-head map, at
// every width with the library's signatures, so one run times every
// design on the same inputs, and nvcc's -Xptxas -v report of this source
// gives the registers and spills of all of them.

#include "../pytorch_geometric_tpu_torch/csrc/packed_gat.cu"

namespace first_design {

template <int G>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  }
  return v;
}

// Forward: rows of the receiver-major CSR; out is (n_rows, H*C + H),
// num in the first H*C columns, den in the last H; m (n_rows, H) the
// shift's max of s, written here.
template <int G>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
               const float* __restrict__ d, const float* __restrict__ s,
               const float* __restrict__ h, float* __restrict__ m,
               const int* __restrict__ seed_ptr, float* __restrict__ out,
               int n_rows, int H, int C, uint32_t thresh, float scale,
               float slope) {
  const long long grp =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (grp >= static_cast<long long>(n_rows) * H) return;
  const int r = static_cast<int>(grp / H);
  const int hd = static_cast<int>(grp % H);
  const int lane = threadIdx.x % G;
  const int HC = H * C;
  const uint32_t seed = static_cast<uint32_t>(__ldg(seed_ptr));
  const float dr = __ldg(d + static_cast<size_t>(r) * H + hd);
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  // the row's shift: the largest s of the head over its senders, the
  // group's lanes taking the edges in turn; 0 for a row without edges
  float mx = -INFINITY;
  for (int e = e0 + lane; e < e1; e += G) {
    mx = fmaxf(mx, __ldg(s + static_cast<size_t>(__ldg(col + e)) * H + hd));
  }
  mx = e1 > e0 ? group_max<G>(mx, group_mask<G>()) : 0.f;
  if (lane == 0) m[static_cast<size_t>(r) * H + hd] = mx;
  const float shift = leaky(mx + dr, slope);
  float* o = out + static_cast<size_t>(r) * (HC + H);
  for (int c0 = 0; c0 < C; c0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    float den = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int src = __ldg(col + e);
      const float z =
          leaky(__ldg(s + static_cast<size_t>(src) * H + hd) + dr, slope);
      const float ex = expf(z - shift);
      den += ex;
      const float w = ex * keep_scale(seed, e, hd, thresh, scale);
      const float* hr =
          h + static_cast<size_t>(src) * HC + hd * C + c0 + lane;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (c0 + lane + k * G < C) acc[k] += w * __ldg(hr + k * G);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = c0 + lane + k * G;
      if (c < C) o[hd * C + c] = acc[k];
    }
    if (c0 == 0 && lane == 0) o[HC + hd] = den;
  }
}

// The first design's forward: packed_gat_fwd's arguments.
int launch_fwd_first(const FwdArgs& f, cudaStream_t stream) {
  with_group_width(f.C, [&](auto width) {
    constexpr int G = decltype(width)::value;
    gat_fwd_kernel<G><<<blocks_for(f.n_rows, f.H, G), kThreads, 0, stream>>>(
        f.row_ptr, f.col, f.d, f.s, f.h, f.m, f.seed, f.out, f.n_rows, f.H,
        f.C, f.thresh, f.scale, f.slope);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace first_design

// The first design's forward: packed_gat_fwd's arguments.
extern "C" int first_packed_gat_fwd(void* row_ptr, void* col, void* d,
                                    void* s, void* h, void* m, void* seed,
                                    void* out, int n_rows, int H, int C,
                                    unsigned thresh, float scale,
                                    float slope, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    return first_design::launch_fwd_first(
        fwd_args(row_ptr, col, d, s, h, m, seed, out, n_rows, H, C, thresh,
                 scale, slope),
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// One walk of the first design: packed_gat_bwd's arguments.
extern "C" int first_packed_gat_bwd(void* row_ptr, void* col, void* eid,
                                    void* d, void* s, void* h, void* m,
                                    void* g, void* seed, void* out_h,
                                    void* dh, int n_rows, int H, int C,
                                    unsigned thresh, float scale,
                                    float slope, int src_side,
                                    void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    return launch_bwd_heads(
        bwd_args(row_ptr, col, eid, d, s, h, m, g, seed, out_h, dh, n_rows,
                 H, C, thresh, scale, slope),
        src_side, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// The wide-head map's forward at any width: packed_gat_fwd's arguments.
extern "C" int wide_packed_gat_fwd(void* row_ptr, void* col, void* d,
                                   void* s, void* h, void* m, void* seed,
                                   void* out, int n_rows, int H, int C,
                                   unsigned thresh, float scale, float slope,
                                   void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    return launch_fwd_wide(
        fwd_args(row_ptr, col, d, s, h, m, seed, out, n_rows, H, C, thresh,
                 scale, slope),
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// One walk of the wide-head map at any width: packed_gat_bwd's arguments.
extern "C" int wide_packed_gat_bwd(void* row_ptr, void* col, void* eid,
                                   void* d, void* s, void* h, void* m,
                                   void* g, void* seed, void* out_h, void* dh,
                                   int n_rows, int H, int C, unsigned thresh,
                                   float scale, float slope, int src_side,
                                   void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    return launch_bwd_wide(
        bwd_args(row_ptr, col, eid, d, s, h, m, g, seed, out_h, dh, n_rows,
                 H, C, thresh, scale, slope),
        src_side, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
