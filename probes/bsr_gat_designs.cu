// Design probe of the block-sparse GAT forward, row pass and column pass
// (pytorch_geometric_tpu_torch/csrc/bsr_gat.cu), built and timed by
// probes/bsr_gat_designs.py. Not part of the port.
//
// The production source is included (its three kernels: one sub-warp per
// row over all heads, the row's mask decoded once into a column list in
// shared memory, whole-row gathers), and beside it the file's first
// design of the same kernels: a group of 8 lanes per (row, head) pair
// that walks its strip's words itself (walk_strip_row), online softmax
// per lane, scalar gathers of the head's channels. The forward and the
// column pass of that design are copied here as they were, in namespace
// first_design; its row pass is the library's own
// bsr_bwd_row_heads_kernel, which the library keeps for one head and for
// the widths its lane map does not cover. first_bsr_gat_fwd,
// first_bsr_gat_bwd_row and first_bsr_gat_bwd_col launch the first design
// at every width with the library's signatures, so one run times both
// designs on the same inputs, and nvcc's -Xptxas -v report of this source
// gives the registers and spills of both.
//
// staged_bsr_gat_fwd is the library's forward (its fwd_row) on a
// persistent grid that copies the next tile of rows' mask into shared
// memory with cp.async while it runs the current one: the asynchronous
// variant that the design was measured against.

#include "../pytorch_geometric_tpu_torch/csrc/bsr_gat.cu"

namespace {
namespace first_design {

// One direction of a block mask (see the head of this file).
struct Strips {
  const int* strip_ptr;
  const int* block_col;
  const uint32_t* words;
  int ti;
  int wj;
};

Strips strips_of(void* strip_ptr, void* block_col, void* words, int ti,
                 int wj) {
  return Strips{static_cast<const int*>(strip_ptr),
                static_cast<const int*>(block_col),
                static_cast<const uint32_t*>(words), ti, wj};
}

// Calls body(c) for every entry (i, c) of row i: the row's words in the
// blocks of its strip (wj per block), each lane of the group on the words
// lane, lane + kGroup, ..., of which it loads kBatch, and their blocks'
// columns, before it looks at any. The lanes run body apart from each
// other: it must not synchronise.
template <typename Body>
__device__ __forceinline__ void walk_strip_row(const Strips& m, int i,
                                               const Group& grp,
                                               Body&& body) {
  const int r = i / m.ti;
  const int li = i - r * m.ti;
  const int k0 = __ldg(m.strip_ptr + r);
  const int count = (__ldg(m.strip_ptr + r + 1) - k0) * m.wj;
  for (int t0 = grp.lane; t0 < count; t0 += kGroup * kBatch) {
    uint32_t words[kBatch];
    int base[kBatch];   // the column of a word's bit 0
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int t = t0 + b * kGroup;
      words[b] = 0u;
      base[b] = 0;
      if (t < count) {
        const int kb = t / m.wj;
        const int w = t - kb * m.wj;
        const size_t k = static_cast<size_t>(k0) + kb;
        words[b] = __ldg(m.words + (k * m.ti + li) * m.wj + w);
        base[b] = (__ldg(m.block_col + k) * m.wj + w) * 32;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      uint32_t word = words[b];
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1u;
        body(base[b] + bit);
      }
    }
  }
}

// Forward: group (i, hd) over row i of the mask.
template <int KC>
__global__ void __launch_bounds__(kThreads)
bsr_fwd_kernel(Strips mask, const float* __restrict__ d,
               const float* __restrict__ s, const float* __restrict__ h,
               const int* __restrict__ seed_ptr, float* __restrict__ out,
               float* __restrict__ lse, int n, int H, int C, uint32_t thresh,
               float scale, float slope) {
  int i, hd;
  if (!group_pair(n, H, &i, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float di = __ldg(d + static_cast<size_t>(i) * H + hd);

  for (int c0 = 0; c0 < C; c0 += KC) {
    // this lane's running maximum, and its sums relative to it
    float m = -INFINITY, l = 0.f, acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    walk_strip_row(mask, i, grp, [&](int j) {
      const float z =
          leaky(di + __ldg(s + static_cast<size_t>(j) * H + hd), slope);
      const float* hj = h + static_cast<size_t>(j) * HC + hd * C + c0;
      if (z > m) {
        const float shrink = expf(m - z);   // 0 on the first entry
        l *= shrink;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[k] *= shrink;
        m = z;
      }
      const float p = expf(z - m);
      l += p;
      const float wgt = keep_scale(salt, i, j, thresh, 1.f) != 0.f ? p : 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (c0 + k < C) acc[k] += wgt * __ldg(hj + k);
      }
    });
    // merge the lanes: bring each to the row's maximum, then add
    const float m_row = grp.max(m);
    const bool any = m_row > -INFINITY;
    const float shrink = any ? expf(m - m_row) : 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] *= shrink;
    l = fmaxf(grp.sum(l * shrink), 1e-20f);
    store_sums<KC>(acc, scale / l,
                   out + static_cast<size_t>(i) * HC + hd * C, c0, C, grp);
    if (c0 == 0 && grp.lane == 0) {
      lse[static_cast<size_t>(i) * H + hd] = (any ? m_row : 0.f) + logf(l);
    }
  }
}

// Backward, column pass: group (j, hd) over row j of the transposed mask
// (an entry i of that row: the mask's entry (i, j)); writes ds and dh.
template <int KC>
__global__ void __launch_bounds__(kThreads)
bsr_bwd_col_kernel(Strips mask_t, const float* __restrict__ d,
                   const float* __restrict__ s, const float* __restrict__ h,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, const float* __restrict__ g,
                   const int* __restrict__ seed_ptr, float* __restrict__ ds,
                   float* __restrict__ dh, int n, int H, int C,
                   uint32_t thresh, float scale, float slope) {
  int j, hd;
  if (!group_pair(n, H, &j, &hd)) return;
  const Group grp;
  const int HC = H * C;
  const uint32_t salt =
      hash_salt(static_cast<uint32_t>(__ldg(seed_ptr)), hd);
  const float sj = __ldg(s + static_cast<size_t>(j) * H + hd);
  const float* hj = h + static_cast<size_t>(j) * HC + hd * C;

  const bool in_regs = C <= KC;   // the head's h row fits the registers
  float hreg[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) hreg[k] = k < C ? __ldg(hj + k) : 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    float acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0.f;
    float sum = 0.f;
    walk_strip_row(mask_t, j, grp, [&](int i) {
      const size_t ih = static_cast<size_t>(i) * H + hd;
      const float zpre = __ldg(d + ih) + sj;
      const float lse_i = __ldg(lse + ih);
      const float Di = __ldg(D + ih);
      const float* gi = g + static_cast<size_t>(i) * HC + hd * C;
      float gv[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        gv[k] = c0 + k < C ? __ldg(gi + c0 + k) : 0.f;
      }
      float dot = 0.f;
      if (in_regs) {
#pragma unroll
        for (int k = 0; k < KC; ++k) dot += gv[k] * hreg[k];
      } else {
        dot = dot_from_memory(gi, hj, C);
      }
      const float alpha = expf(leaky(zpre, slope) - lse_i);
      const float ks = keep_scale(salt, i, j, thresh, scale);
      const float beta = alpha * ks;
      const float dz = alpha * (ks * dot - Di);
      sum += zpre > 0.f ? dz : slope * dz;
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[k] += beta * gv[k];
    });
    store_sums<KC>(acc, 1.f, dh + static_cast<size_t>(j) * HC + hd * C, c0,
                   C, grp);
    if (c0 == 0) {
      sum = grp.sum(sum);
      if (grp.lane == 0) ds[static_cast<size_t>(j) * H + hd] = sum;
    }
  }
}

}  // namespace first_design

namespace staged {

// Blocks of a tile of rows whose mask the stage holds; the rest of a
// longer tile is read from device memory.
constexpr int kStageBlocks = 512;

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The mask reads of a tile's rows (Strips' three) from a copy staged in
// shared memory: strip_ptr of its R rows and one past, and the first nb
// of its blocks' columns and words (tiles one row high and one word wide,
// so consecutive rows' blocks are one range).
struct Staged {
  Strips m;
  const int* sp;        // strip_ptr[r0 .. r0 + R]
  const int* bc;        // block_col[kb .. kb + nb)
  const uint32_t* wd;   // words[kb .. kb + nb)
  int r0, R;
  size_t kb;
  int nb, ti, wj;
  __device__ __forceinline__ int strip_start(int r) const {
    return r - r0 <= R ? sp[r - r0] : __ldg(m.strip_ptr + r);
  }
  __device__ __forceinline__ int column_tile(size_t k) const {
    return k - kb < static_cast<size_t>(nb) ? bc[k - kb]
                                            : __ldg(m.block_col + k);
  }
  __device__ __forceinline__ uint32_t word(size_t k, int, int) const {
    return k - kb < static_cast<size_t>(nb) ? wd[k - kb] : __ldg(m.words + k);
  }
};

// Ints of one stage of R rows.
__host__ __device__ constexpr int stage_ints(int R) {
  return R + 1 + 2 * kStageBlocks;
}

// Forward over tiles of R = blockDim / L consecutive rows, a persistent
// grid: while the sub-warps of a block run the rows of one tile (the
// library's fwd_row), cp.async copies the next tile's strip pointers,
// block columns and words into the other half of a two-stage ring; the
// tile after that has its range [strip_ptr[r0], strip_ptr[r0 + R]) read
// one step ahead.
template <int L, int V>
__global__ void __launch_bounds__(kThreads)
bsr_fwd_staged_kernel(Strips mask, FwdArgs a) {
  extern __shared__ float smem[];
  const int R = blockDim.x / L;
  const int sub = threadIdx.x / L;
  const int n = a.n;
  int* ring = reinterpret_cast<int*>(smem + R * fwd_floats(a.H, L));
  const int tiles = (n + R - 1) / R;
  const int G = gridDim.x;
  const auto range = [&](int tile, int& kb, int& ke) {
    kb = __ldg(mask.strip_ptr + tile * R);
    ke = __ldg(mask.strip_ptr + min(tile * R + R, n));
  };
  const auto stage = [&](int tile, int buf, int kb, int ke) {
    int* sp = ring + buf * stage_ints(R);
    const int rows = min(R, n - tile * R);
    for (int t = threadIdx.x; t <= rows; t += blockDim.x) {
      copy4(sp + t, mask.strip_ptr + tile * R + t);
    }
    const int nb = min(ke - kb, kStageBlocks);
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      copy4(sp + R + 1 + t, mask.block_col + kb + t);
      copy4(sp + R + 1 + kStageBlocks + t, mask.words + kb + t);
    }
    commit();
  };
  int t = blockIdx.x;
  if (t >= tiles) return;
  int kb, ke, kb_next = 0, ke_next = 0;
  range(t, kb, ke);
  stage(t, 0, kb, ke);
  if (t + G < tiles) range(t + G, kb_next, ke_next);
  for (int buf = 0; t < tiles; t += G, buf ^= 1) {
    wait_all();
    __syncthreads();   // this tile's stage is in; the other is free
    const int kb_cur = kb, ke_cur = ke;
    if (t + G < tiles) stage(t + G, buf ^ 1, kb_next, ke_next);
    kb = kb_next;
    ke = ke_next;
    if (t + 2 * G < tiles) range(t + 2 * G, kb_next, ke_next);
    const int i = t * R + sub;
    if (i < n) {
      const int* sp = ring + buf * stage_ints(R);
      const Staged src{mask,
                       sp,
                       sp + R + 1,
                       reinterpret_cast<const uint32_t*>(sp + R + 1 +
                                                         kStageBlocks),
                       t * R,
                       R,
                       static_cast<size_t>(kb_cur),
                       min(ke_cur - kb_cur, kStageBlocks),
                       1,
                       1};
      fwd_row<L, V>(src, i, a, smem + sub * fwd_floats(a.H, L));
    }
  }
}

}  // namespace staged
}  // namespace

// Forward of the first design: bsr_gat_fwd's arguments.
extern "C" int first_bsr_gat_fwd(void* strip_ptr, void* block_col,
                                 void* words, void* d, void* s, void* h,
                                 void* seed, void* out, void* lse, int n,
                                 int ti, int wj, int H, int C,
                                 unsigned thresh, float scale, float slope,
                                 void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      first_design::bsr_fwd_kernel<KC><<<blocks_for(n, H), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
          first_design::strips_of(strip_ptr, block_col, words, ti, wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const int*>(seed),
          static_cast<float*>(out), static_cast<float*>(lse), n, H, C,
          thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Row pass of the first design: bsr_gat_bwd_row's arguments. The library
// keeps it for the widths its redesigned row pass does not take; here it
// runs at every width.
extern "C" int first_bsr_gat_bwd_row(void* strip_ptr, void* block_col,
                                     void* words, void* d, void* s, void* h,
                                     void* lse, void* out, void* g,
                                     void* seed, void* dd, void* D, int n,
                                     int ti, int wj, int H, int C,
                                     unsigned thresh, float scale,
                                     float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    return launch_row_heads(strips_of(strip_ptr, block_col, words, ti, wj),
                            d, s, h, lse, out, g, seed, dd, D, n, H, C,
                            thresh, scale, slope,
                            static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// Column pass of the first design: bsr_gat_bwd_col's arguments.
extern "C" int first_bsr_gat_bwd_col(void* strip_ptr_t, void* block_col_t,
                                     void* words_t, void* d, void* s,
                                     void* h, void* lse, void* D, void* g,
                                     void* seed, void* ds, void* dh, int n,
                                     int ti, int wj, int H, int C,
                                     unsigned thresh, float scale,
                                     float slope, void* stream) {
  if (n > 0 && H > 0 && C > 0) {
    with_channel_chunk(C, [&](auto chunk) {
      constexpr int KC = decltype(chunk)::value;
      first_design::bsr_bwd_col_kernel<KC>
          <<<blocks_for(n, H), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
              first_design::strips_of(strip_ptr_t, block_col_t, words_t, ti,
                                      wj),
          static_cast<const float*>(d), static_cast<const float*>(s),
          static_cast<const float*>(h), static_cast<const float*>(lse),
          static_cast<const float*>(D), static_cast<const float*>(g),
          static_cast<const int*>(seed), static_cast<float*>(ds),
          static_cast<float*>(dh), n, H, C, thresh, scale, slope);
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// Forward of the staged design: bsr_gat_fwd's arguments; tiles of one row
// by one word only (the operator's default), else cudaErrorInvalidValue.
extern "C" int staged_bsr_gat_fwd(void* strip_ptr, void* block_col,
                                  void* words, void* d, void* s, void* h,
                                  void* seed, void* out, void* lse, int n,
                                  int ti, int wj, int H, int C,
                                  unsigned thresh, float scale, float slope,
                                  void* stream) {
  if (ti != 1 || wj != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && H > 0 && C > 0) {
    int rc = 0;
    const bool aligned = aligned16(h) && aligned16(out);
    with_lanes(H, C, n, aligned, [&](auto lanes, auto vec) {
      constexpr int L = decltype(lanes)::value;
      constexpr int V = decltype(vec)::value;
      const int R = kThreads / L;
      const size_t bytes =
          (static_cast<size_t>(R) * fwd_floats(H, L) +
           2 * staged::stage_ints(R)) * sizeof(float);
      const auto kernel = staged::bsr_fwd_staged_kernel<L, V>;
      if (bytes > 48 * 1024) {
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
      }
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    bytes);
      const int tiles = (n + R - 1) / R;
      const int grid = min(tiles, max(per_sm, 1) * sms);
      kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          strips_of(strip_ptr, block_col, words, ti, wj),
          FwdArgs{static_cast<const float*>(d), static_cast<const float*>(s),
                  static_cast<const float*>(h), static_cast<const int*>(seed),
                  static_cast<float*>(out), static_cast<float*>(lse), n, H,
                  C, lanes_of<L, V>(H, C), thresh, scale, slope});
      rc = static_cast<int>(cudaGetLastError());
    });
    return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
