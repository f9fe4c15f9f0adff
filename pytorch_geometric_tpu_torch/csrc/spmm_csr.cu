// Weighted CSR SpMM for Hopper (sm_90a):
//
//   out[r, :] = sum_{p in [row_ptr[r], row_ptr[r+1])} val[p] * x[col[p], :]
//
// Replaces the Pallas kernel pytorch_geometric_tpu/ops/spmm.py:_spmm_kernel
// (driven by _spmm_pallas_raw). That kernel turns gather and scatter into
// one-hot matrix products over (source window, destination window) tiles
// because the TPU has no fast random access; a GPU has, so one row-parallel
// kernel over a CSR takes every edge. The backward of a static-weight SpMM
// is the same kernel over the transposed CSR.
//
// What bounds it: bytes. Per call it must read col and val (8 B per edge),
// row_ptr (4 B per row), each row of x once (F * sizeof(T) per source row)
// and write out (4 B * F per row); it does 2 flops per edge and feature,
// far below the card's rate for so few bytes. At Cora's shapes (3072 rows,
// about 13.6k edges with self loops, F = 16) that is about 0.5 MB, about
// 0.15 us at 3.35 TB/s: the call is bound by launch latency, not by the card.
//
// Design:
// - A group of G lanes (G = 4, 8, 16 or 32, the smallest power of two
//   >= min(F, 32)) owns one row, so the narrow widths of the main path
//   (F = 16 and 7) keep most lanes busy: 256 / G rows per block. Each lane
//   keeps kVec accumulators, features lane, lane + G, ...; wider F loops
//   over chunks of G * kVec features.
// - A row's edges are summed by one group, in CSR order, so the time of a
//   call follows its longest row. The GCN path builds its CSRs from the
//   real edges and the self loops only (the zero-weight padding edges, which
//   all point at one padding node, are left out), so its rows are short.
// - No atomics: every output row is written by exactly one group, with sums
//   in a fixed order, so the result is deterministic. Rows with no edges
//   are written as 0, so the caller may allocate out with torch.empty.
// - x is fp32 or bf16; products and sums are fp32; out is fp32.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/spmm.py); the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const T* __restrict__ x,
                float* __restrict__ out, int n_rows, int F) {
  constexpr int kRows = kThreads / G;  // rows per block
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * kRows + threadIdx.x / G;
  if (r >= n_rows) return;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  float* o = out + static_cast<size_t>(r) * F;
  for (int f0 = 0; f0 < F; f0 += G * kVec) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const float w = __ldg(val + e);
      const T* xr = x + static_cast<size_t>(__ldg(col + e)) * F + f0 + lane;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (f0 + lane + k * G < F) acc[k] += w * load_x(xr + k * G);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int f = f0 + lane + k * G;
      if (f < F) o[f] = acc[k];
    }
  }
}

template <typename T, int G>
void launch(const int* row_ptr, const int* col, const float* val, const T* x,
            float* out, int n_rows, int F, cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const int blocks = (n_rows + kRows - 1) / kRows;
  spmm_csr_kernel<T, G><<<blocks, kThreads, 0, stream>>>(row_ptr, col, val, x,
                                                         out, n_rows, F);
}

template <typename T>
void dispatch(const int* row_ptr, const int* col, const float* val,
              const T* x, float* out, int n_rows, int F,
              cudaStream_t stream) {
  if (F <= 4) {
    launch<T, 4>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (F <= 8) {
    launch<T, 8>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else if (F <= 16) {
    launch<T, 16>(row_ptr, col, val, x, out, n_rows, F, stream);
  } else {
    launch<T, 32>(row_ptr, col, val, x, out, n_rows, F, stream);
  }
}

}  // namespace

extern "C" int spmm_csr(void* row_ptr, void* col, void* val, void* x,
                        void* out, int n_rows, int F, int x_is_bf16,
                        void* stream) {
  if (n_rows > 0 && F > 0) {
    const int* rp = static_cast<const int*>(row_ptr);
    const int* c = static_cast<const int*>(col);
    const float* v = static_cast<const float*>(val);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_is_bf16) {
      dispatch(rp, c, v, static_cast<const __nv_bfloat16*>(x), o, n_rows, F,
               s);
    } else {
      dispatch(rp, c, v, static_cast<const float*>(x), o, n_rows, F, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
