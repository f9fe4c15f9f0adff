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
// is ~7.7 MB, ~2.3 us at 3.35 TB/s; at DNA's key-value gradient on Cora
// (3072 rows, ~13.6k messages of 1024 fp32) 68 MB, 20.4 us.
//
// Designs (segment_sum.cuh holds both and says how each meets the bound):
// - Up to 32 chunks a row (F <= 128 fp32 in 16-byte loads), the first
//   design: a group of G lanes owns one row; at F = 16 fp32 a row's group
//   is 4 lanes and one message is one 64-byte read, and a warp reads one
//   contiguous stretch of messages.
// - Past them, the chunk map: a warp per (row, 32 VEC channels), the
//   loads of 8 messages issued together. At F = 1024 fp32 on Cora that is
//   24.6k warps, three waves of the card, where the first design had 3072
//   warps, each lane walking its row 8 times.
// - Sums run in CSR order, one accumulator per element, in both designs,
//   so the chunk map's output is bitwise equal to the first design's; no
//   atomics, so two launches are bitwise equal. Rows with no messages are
//   written as 0 (out may come from torch.empty).
// - msgs is fp32 or bf16; sums and out are fp32.
// - The kernels live in segment_sum.cuh, which packed_rgcn.cu includes
//   too: the RGCN forward sums its per-edge messages with it.
//
// Times on an NVIDIA H100 80GB HBM3 at 700 W, warm device us per call,
// first design -> the library, both timed in one run by
// probes/segment_sum_designs.py (PERF.md): DNA's key-value gradients by
// sender on Cora, fp32, F = 1024 39.5 -> 25.6 (bound 20.4;
// torch.segment_reduce 35.2), 768 30.5 -> 19.8, 512 8.1 -> 8.0, 256 5.0
// -> 4.4; the RGCN hub operator's receiver of 3,013 messages (C = 33)
// 221 -> 124; the first design's widths unchanged (RCM-PubMed F = 16 3.6,
// bound 2.7; DNA F = 128 by receiver 3.2).
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
