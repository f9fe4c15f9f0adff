// Design probe of the dense-mask GAT forward and backward
// (pytorch_geometric_tpu_torch/csrc/flash_gat.cu), built and timed by
// probes/flash_gat_designs.py. Not part of the port.
//
// The production source is included. Its forward has two designs: the
// row map (flash_fwd_row_kernel: a warp per mask row over all heads, one
// lane per (entry, head), the softmax chunk by chunk), which
// flash_gat_fwd launches where the map takes (H, C), and the first design
// (flash_fwd_kernel: a group of 8 lanes per (row, head) walking the row's
// words itself), which the library keeps for the other widths;
// first_flash_gat_fwd launches the first design at every width.
//
// Its backward has two designs: the
// sub-warp design (flash_bwd_row_kernel, flash_bwd_col_kernel: a warp per
// mask row over all heads, the row's words read once and decoded into a
// column list, one lane per (entry, head), whole-row gathers), which
// flash_gat_bwd_row and flash_gat_bwd_col launch where its map takes
// (H, C); and the source's first design (flash_bwd_row_heads_kernel,
// flash_bwd_col_heads_kernel: a group of 8 lanes per (row, head) walking
// the row's words itself), which the library keeps for the other widths.
// first_flash_gat_bwd_row and first_flash_gat_bwd_col launch the first
// design at every width, and lanes_flash_gat_bwd_row and
// lanes_flash_gat_bwd_col the sub-warp design with the lanes a row given
// (8, 16 or 32; the library takes 32), all with the library's
// signatures (the lanes before the stream), so one run times the designs
// on the same inputs, and nvcc's -Xptxas -v report of this source gives
// the registers and spills of each.
//
// channels_flash_gat_bwd_col is the column pass with the block-sparse
// column pass's lane map (bsr_gat.cu: bsr_bwd_col_kernel) on the dense
// mask: le lanes share one row of H C channels, V a lane, the channels of
// a head on cv neighbouring lanes, the dot a shuffle over them, every
// lane of a head forming its alpha, keep and beta; the map the library's
// column pass (one lane per (entry, head)) was measured against.

#include "../pytorch_geometric_tpu_torch/csrc/flash_gat.cu"

namespace {

// The lane map of a channel-map launch: le lanes share one row of H C
// channels, V channels each, the channels of each head on cv neighbouring
// lanes (cv = 0: the map does not take (H, C)).
struct Lanes {
  int le, cv;
};

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

Lanes lanes_of(int L, int V, int H, int C) {
  const int HC = H * C;
  const int slots = (HC + V - 1) / V;
  Lanes ln;
  ln.le = L < pow2_at_least(slots) ? L : pow2_at_least(slots);
  const int cv = C / V;
  const bool covered = ln.le * V >= HC;
  ln.cv = cv == pow2_at_least(cv) && cv <= ln.le && covered ? cv : 0;
  if (H == 1 && covered) ln.cv = ln.le;   // one head: all le lanes
  return ln;
}

__host__ __device__ constexpr int rows_of(int V) { return V == 4 ? 2 : 4; }

template <int NB, int V>
__device__ __forceinline__ void load_rows(float (&x)[NB][V],
                                          const float* src, const int* cols,
                                          int e0, int R, int ne, int HC,
                                          int c) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int e = e0 + b * R;
    if (e < ne && c >= 0) {
      load_vec<V>(src + static_cast<size_t>(cols[e]) * HC + c, x[b]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[b][v] = 0.f;
    }
  }
}

template <int L, int V>
__global__ void __launch_bounds__(kThreads)
flash_bwd_col_channels_kernel(const uint32_t* __restrict__ bits_t,
                              const float* __restrict__ d,
                              const float* __restrict__ s,
                              const float* __restrict__ h,
                              const float* __restrict__ lse,
                              const float* __restrict__ D,
                              const float* __restrict__ g,
                              const int* __restrict__ seed_ptr,
                              float* __restrict__ ds, float* __restrict__ dh,
                              int n, int W, int H, int C, Lanes lanes,
                              uint32_t thresh, float scale, float slope) {
  constexpr int NB = rows_of(V);
  extern __shared__ int smem[];
  const Row<L> row;
  const int sub = threadIdx.x / L;
  const int j = blockIdx.x * (blockDim.x / L) + sub;
  if (j >= n) return;
  const int HC = H * C;
  const size_t jrow = static_cast<size_t>(j);
  const int chunk = chunk_of(H, L);
  int* cols = smem + sub * chunk;
  const int q = row.lane % lanes.le;
  const int r0 = row.lane / lanes.le;
  const int R = L / lanes.le;
  const int cv = lanes.cv;
  const bool owner = q % cv == 0;
  const int c = q * V < HC ? q * V : -1;
  const int hc = c >= 0 ? c / C : 0;
  float hj[V];
  if (c >= 0) {
    load_vec<V>(h + jrow * HC + c, hj);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) hj[v] = 0.f;
  }
  const float sj = __ldg(s + jrow * H + hc);
  const uint32_t salt = hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hc);
  float acc[V], ds_acc = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  Cursor cur{0, 0, 0};
  const uint32_t* mrow = bits_t + jrow * W;
  for (;;) {
    const int ne = decode_chunk<L>(mrow, W, cur, cols, chunk, row);
    if (ne == 0) break;
    for (int e0 = r0; e0 - r0 < ne; e0 += R * NB) {
      float gv[NB][V], dv[NB], lv[NB], Dv[NB];
      load_rows<NB, V>(gv, g, cols, e0, R, ne, HC, c);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        dv[b] = lv[b] = Dv[b] = 0.f;
        if (e < ne && c >= 0) {
          const size_t ih = static_cast<size_t>(cols[e]) * H + hc;
          dv[b] = __ldg(d + ih);
          lv[b] = __ldg(lse + ih);
          Dv[b] = __ldg(D + ih);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int e = e0 + b * R;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) dot += gv[b][v] * hj[v];
        dot = row.sum_below(dot, cv);
        if (e < ne && c >= 0) {
          const float zpre = dv[b] + sj;
          const float alpha = expf(leaky(zpre, slope) - lv[b]);
          const float ks = keep_scale(salt, cols[e], j, thresh, scale);
          const float beta = alpha * ks;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += beta * gv[b][v];
          if (owner) {
            const float dz = alpha * (ks * dot - Dv[b]);
            ds_acc += zpre > 0.f ? dz : slope * dz;
          }
        }
      }
    }
    if (ne < chunk) break;
  }
  ds_acc = row.sum_from(ds_acc, lanes.le);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = row.sum_from(acc[v], lanes.le);
  if (r0 == 0 && c >= 0) {
    store_vec<V>(dh + jrow * HC + c, acc);
    if (owner) ds[jrow * H + hc] = ds_acc;
  }
}

}  // namespace

// The forward's first design (flash_fwd_kernel: a group of 8 lanes per
// (row, head), an online softmax per lane) at every width, with
// flash_gat_fwd's signature.
extern "C" int first_flash_gat_fwd(void* bits, void* d, void* s, void* h,
                                   void* seed, void* out, void* lse, int n,
                                   int W, int H, int C, unsigned thresh,
                                   float scale, float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    return launch_fwd_heads(fwd_args(bits, d, s, h, seed, out, lse, n, W, H,
                                     C, thresh, scale, slope, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_flash_gat_bwd_row(void* bits, void* d, void* s,
                                       void* h, void* lse, void* out,
                                       void* g, void* seed, void* dd,
                                       void* D, int n, int W, int H, int C,
                                       unsigned thresh, float scale,
                                       float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    return launch_row_heads(bwd_args(bits, d, s, h, lse, out, g, seed, dd,
                                     D, n, W, H, C, thresh, scale, slope,
                                     stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_flash_gat_bwd_col(void* bits_t, void* d, void* s,
                                       void* h, void* lse, void* D,
                                       void* g, void* seed, void* ds,
                                       void* dh, int n, int W, int H, int C,
                                       unsigned thresh, float scale,
                                       float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    return launch_col_heads(bwd_args(bits_t, d, s, h, lse, D, g, seed, ds,
                                     dh, n, W, H, C, thresh, scale, slope,
                                     stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// The sub-warp row pass at `lanes` (8, 16 or 32) lanes a row;
// cudaErrorInvalidValue where its map does not take (H, C, lanes).
extern "C" int lanes_flash_gat_bwd_row(void* bits, void* d, void* s,
                                       void* h, void* lse, void* out,
                                       void* g, void* seed, void* dd,
                                       void* D, int n, int W, int H, int C,
                                       unsigned thresh, float scale,
                                       float slope, int lanes,
                                       void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    const BwdArgs a = bwd_args(bits, d, s, h, lse, out, g, seed, dd, D, n,
                               W, H, C, thresh, scale, slope, stream);
    const int rc = lanes == 8    ? launch_row_lanes<8>(a)
                   : lanes == 16 ? launch_row_lanes<16>(a)
                   : lanes == 32 ? launch_row_lanes<32>(a)
                                 : -1;
    return rc >= 0 ? rc : static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The sub-warp column pass at `lanes` (8, 16 or 32) lanes a row;
// cudaErrorInvalidValue where its map does not take (H, C, lanes).
extern "C" int lanes_flash_gat_bwd_col(void* bits_t, void* d, void* s,
                                       void* h, void* lse, void* D,
                                       void* g, void* seed, void* ds,
                                       void* dh, int n, int W, int H, int C,
                                       unsigned thresh, float scale,
                                       float slope, int lanes,
                                       void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    const BwdArgs a = bwd_args(bits_t, d, s, h, lse, D, g, seed, ds, dh, n,
                               W, H, C, thresh, scale, slope, stream);
    const int rc = lanes == 8    ? launch_col_lanes<8>(a)
                   : lanes == 16 ? launch_col_lanes<16>(a)
                   : lanes == 32 ? launch_col_lanes<32>(a)
                                 : -1;
    return rc >= 0 ? rc : static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column pass with the channel map at `lanes` lanes a row;
// cudaErrorInvalidValue where the map does not take (H, C, lanes).
extern "C" int channels_flash_gat_bwd_col(void* bits_t, void* d, void* s,
                                          void* h, void* lse, void* D,
                                          void* g, void* seed, void* ds,
                                          void* dh, int n, int W, int H,
                                          int C, unsigned thresh,
                                          float scale, float slope,
                                          int lanes, void* stream) {
  if (n <= 0 || H <= 0 || C <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = aligned16(h) && aligned16(g) && aligned16(dh);
  const int V = channels_per_lane(C, aligned);
  const Lanes ln = lanes_of(lanes, V, H, C);
  if (ln.cv == 0 || H > lanes ||
      (lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = 0;
  with_row_lanes(lanes, V, [&](auto l, auto v) {
    constexpr int L = decltype(l)::value;
    rc = launch_rows<L>(
        flash_bwd_col_channels_kernel<L, decltype(v)::value>, n,
        chunk_of(H, L), static_cast<cudaStream_t>(stream),
        static_cast<const uint32_t*>(bits_t), static_cast<const float*>(d),
        static_cast<const float*>(s), static_cast<const float*>(h),
        static_cast<const float*>(lse), static_cast<const float*>(D),
        static_cast<const float*>(g), static_cast<const int*>(seed),
        static_cast<float*>(ds), static_cast<float*>(dh), n, W, H, C, ln,
        thresh, scale, slope);
  });
  return rc;
}
