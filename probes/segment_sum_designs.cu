// Design probe of the receiver-sorted segment sum
// (pytorch_geometric_tpu_torch/csrc/segment_sum.cuh, launched by
// csrc/sorted_spmm.cu), built and timed by probes/segment_sum_designs.py.
// Not part of the port.
//
// The production source is included. The header has two designs: the
// first (sorted_segment_sum_kernel: a group of lanes a row, each lane
// walking the row's edges once for each of its chunks of channels), which
// sorted_segment_sum launches up to 32 chunks a row; and the chunk map
// (segment_sum_chunks_kernel: a warp per (row, chunk of 32 VEC K
// channels), the loads of 8 edges issued together), which it launches
// past them. first_segment_sum launches the first design at every width
// with sorted_segment_sum's signature, and chunks_segment_sum the chunk
// map with K given (1, 2 or 4) before the stream, so one run times the
// designs on the same inputs, and nvcc's -Xptxas -v report of this
// source gives the registers and spills of each.

#include "../pytorch_geometric_tpu_torch/csrc/sorted_spmm.cu"

namespace {

// One design (segment_sum::launch_design: 0 the first, K the chunk map)
// with msgs typed by msgs_is_bf16.
int launch_probe(void* row_ptr, void* msgs, void* out, int n_rows, int F,
           int msgs_is_bf16, int design, void* stream) {
  if (n_rows > 0 && F > 0) {
    const int* rp = static_cast<const int*>(row_ptr);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (msgs_is_bf16) {
      segment_sum::launch_design(
          rp, static_cast<const __nv_bfloat16*>(msgs), o, n_rows, F, design,
          s);
    } else {
      segment_sum::launch_design(rp, static_cast<const float*>(msgs), o,
                                 n_rows, F, design, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first design: sorted_segment_sum's arguments.
extern "C" int first_segment_sum(void* row_ptr, void* msgs, void* out,
                                 int n_rows, int F, int msgs_is_bf16,
                                 void* stream) {
  return launch_probe(row_ptr, msgs, out, n_rows, F, msgs_is_bf16, 0, stream);
}

// The chunk map at K loads a lane an edge (1, 2 or 4), at any width:
// sorted_segment_sum's arguments, then K, then the stream.
extern "C" int chunks_segment_sum(void* row_ptr, void* msgs, void* out,
                                  int n_rows, int F, int msgs_is_bf16, int K,
                                  void* stream) {
  return launch_probe(row_ptr, msgs, out, n_rows, F, msgs_is_bf16,
                K < 1 ? 1 : K, stream);
}
