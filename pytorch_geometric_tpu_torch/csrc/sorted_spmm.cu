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
// - The kernel lives in segment_sum.cuh, which packed_rgcn.cu includes
//   too: the RGCN forward sums its per-edge messages with it.
//
// Plain C interface, bound from Python with ctypes
// (pytorch_geometric_tpu_torch/ops/sorted_spmm.py); the launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include "segment_sum.cuh"

extern "C" int sorted_segment_sum(void* row_ptr, void* msgs, void* out,
                                  int n_rows, int F, int msgs_is_bf16,
                                  void* stream) {
  if (n_rows > 0 && F > 0) {
    const int* rp = static_cast<const int*>(row_ptr);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (msgs_is_bf16) {
      segment_sum::dispatch(rp, static_cast<const __nv_bfloat16*>(msgs), o,
                            n_rows, F, s);
    } else {
      segment_sum::dispatch(rp, static_cast<const float*>(msgs), o, n_rows,
                            F, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
