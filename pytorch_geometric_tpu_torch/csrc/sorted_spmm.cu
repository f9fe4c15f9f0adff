// Receiver-sorted segment sum for Hopper (sm_90a):
//
//   out[r, :] = sum_{p in [row_ptr[r], row_ptr[r+1])} msgs[p, :]
//
// Replaces the Pallas kernel pytorch_geometric_tpu/ops/sorted_spmm.py:
// _scatter_kernel (driven by _scatter_tiles). That kernel cuts the
// receiver-sorted messages into tile-edge chunks aligned to rows-sized
// output blocks and scatters each chunk with a one-hot matrix product,
// because the TPU has no fast scatter. On a GPU the messages of a row are
// already contiguous in CSR order, so one group of lanes per row reads them
// in order and sums: none of the tiles, cuts, local_dst, tile_first flags,
// one-hot products or transposed outputs is carried over.
//
// What bounds it: bytes. Per call it must read every message once (E * F
// * sizeof(T)), row_ptr (4 B per row) and write out (4 B * F per row); it
// does one add per message element, far below the card's rate. At the
// RCM-reordered PubMed GCN CSR (24576 rows, ~113k edges, F = 16, fp32) that
// is ~7.7 MB, ~2.3 us at 3.35 TB/s.
//
// Design:
// - A group of G lanes owns one row. Each lane reads VEC elements of a
//   message with one vector load (16 bytes: 4 fp32 or 8 bf16) where the
//   width and the base allow it, else one element; G is the smallest power
//   of two >= min(chunks, 32), chunks = ceil(F / VEC). At F = 16 fp32 a
//   row's group is 4 lanes and one message is one 64-byte read; the rows
//   of consecutive groups follow each other in memory, so a warp reads one
//   contiguous stretch of messages.
// - Sums run in CSR order, one accumulator per element, no atomics: every
//   output row is written by one group, so two launches are bitwise equal.
//   Rows with no messages are written as 0 (out may come from torch.empty).
// - msgs is fp32 or bf16; sums and out are fp32.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/sorted_spmm.py); the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// VEC consecutive elements of p as floats: one 16-byte load where VEC
// spans 16 bytes, else VEC scalar loads.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
};

template <>
struct Loader<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const int* __restrict__ row_ptr,
                          const T* __restrict__ msgs,
                          float* __restrict__ out, int n_rows, int F) {
  constexpr int kRows = kThreads / G;  // rows per block
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * kRows + threadIdx.x / G;
  if (r >= n_rows) return;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  const int chunks = (F + VEC - 1) / VEC;  // VEC > 1 only when VEC | F
  float* o = out + static_cast<size_t>(r) * F;
  for (int c = lane; c < chunks; c += G) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const T* m = msgs + static_cast<size_t>(e0) * F + c * VEC;
#pragma unroll 4
    for (int e = e0; e < e1; ++e, m += F) {
      float v[VEC];
      Loader<T, VEC>::load(m, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[c * VEC + k] = acc[k];
  }
}

template <typename T, int VEC, int G>
void launch(const int* row_ptr, const T* msgs, float* out, int n_rows, int F,
            cudaStream_t stream) {
  constexpr int kRows = kThreads / G;
  const int blocks = (n_rows + kRows - 1) / kRows;
  sorted_segment_sum_kernel<T, VEC, G>
      <<<blocks, kThreads, 0, stream>>>(row_ptr, msgs, out, n_rows, F);
}

template <typename T, int VEC>
void dispatch_lanes(const int* row_ptr, const T* msgs, float* out, int n_rows,
                    int F, cudaStream_t stream) {
  const int chunks = (F + VEC - 1) / VEC;
  if (chunks <= 4) {
    launch<T, VEC, 4>(row_ptr, msgs, out, n_rows, F, stream);
  } else if (chunks <= 8) {
    launch<T, VEC, 8>(row_ptr, msgs, out, n_rows, F, stream);
  } else if (chunks <= 16) {
    launch<T, VEC, 16>(row_ptr, msgs, out, n_rows, F, stream);
  } else {
    launch<T, VEC, 32>(row_ptr, msgs, out, n_rows, F, stream);
  }
}

template <typename T>
void dispatch(const int* row_ptr, const T* msgs, float* out, int n_rows,
              int F, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  const bool aligned = reinterpret_cast<uintptr_t>(msgs) % 16 == 0;
  if (aligned && F % kVec == 0) {
    dispatch_lanes<T, kVec>(row_ptr, msgs, out, n_rows, F, stream);
  } else {
    dispatch_lanes<T, 1>(row_ptr, msgs, out, n_rows, F, stream);
  }
}

}  // namespace

extern "C" int sorted_segment_sum(void* row_ptr, void* msgs, void* out,
                                  int n_rows, int F, int msgs_is_bf16,
                                  void* stream) {
  if (n_rows > 0 && F > 0) {
    const int* rp = static_cast<const int*>(row_ptr);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (msgs_is_bf16) {
      dispatch(rp, static_cast<const __nv_bfloat16*>(msgs), o, n_rows, F, s);
    } else {
      dispatch(rp, static_cast<const float*>(msgs), o, n_rows, F, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
