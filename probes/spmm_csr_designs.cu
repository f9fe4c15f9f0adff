// Design probe of the CSR SpMM (pytorch_geometric_tpu_torch/csrc/spmm_csr.cu),
// built and timed by probes/spmm_csr_designs.py. Not part of the port.
//
// The production source is included. It has three designs: the row map
// (spmm_csr_rows_kernel: L lanes a row, P of them across the channels at
// V a lane, the row's edges spread over the R = L / P entry groups, the
// partial sums met in a fixed tree), which spmm_csr launches wherever F
// takes at most 32 channel slots; the chunk map (spmm_csr_chunks_kernel:
// a warp per (row, chunk of 32 V K channels), the gathers of up to 8
// edges issued together), which it launches past 32 slots; and the first
// design (spmm_csr_kernel: a group of lanes per row walking its edges one
// after another), which the library keeps for bf16 x of 65 to 128
// channels.
// first_spmm_csr launches the first design at every width with
// spmm_csr's signature, lanes_spmm_csr the row map with the lanes a row
// given (16 or 32; the library picks by the rows, rows_lanes) before the
// stream, and chunks_spmm_csr the chunk map with K given (1 to 16; 0:
// the library's) before the stream, so one run times the designs on the
// same inputs, and nvcc's -Xptxas -v report of this source gives the
// registers and spills of each.

#include "../pytorch_geometric_tpu_torch/csrc/spmm_csr.cu"

// The first design: spmm_csr's arguments.
extern "C" int first_spmm_csr(void* row_ptr, void* col, void* val, void* x,
                              void* out, int n_rows, int F, int x_is_bf16,
                              void* stream) {
  if (n_rows > 0 && F > 0) {
    with_x_type(x, x_is_bf16, [&](auto xt) {
      dispatch_first(static_cast<const int*>(row_ptr),
                     static_cast<const int*>(col),
                     static_cast<const float*>(val), xt,
                     static_cast<float*>(out), n_rows, F,
                     static_cast<cudaStream_t>(stream));
    });
  }
  return static_cast<int>(cudaGetLastError());
}

// The row map at `lanes` lanes a row (16 or 32): spmm_csr's arguments,
// then the lanes, then the stream. -1 where the map does not take F.
extern "C" int lanes_spmm_csr(void* row_ptr, void* col, void* val, void* x,
                              void* out, int n_rows, int F, int x_is_bf16,
                              int lanes, void* stream) {
  bool taken = true;
  if (n_rows > 0 && F > 0) {
    with_x_type(x, x_is_bf16, [&](auto xt) {
      taken = dispatch_rows(static_cast<const int*>(row_ptr),
                            static_cast<const int*>(col),
                            static_cast<const float*>(val), xt,
                            static_cast<float*>(out), n_rows, F, lanes,
                            static_cast<cudaStream_t>(stream));
    });
  }
  return taken ? static_cast<int>(cudaGetLastError()) : -1;
}

// The chunk map at K loads a lane an edge, at any width: spmm_csr's
// arguments, then K, then the stream.
extern "C" int chunks_spmm_csr(void* row_ptr, void* col, void* val, void* x,
                               void* out, int n_rows, int F, int x_is_bf16,
                               int K, void* stream) {
  if (n_rows > 0 && F > 0) {
    with_x_type(x, x_is_bf16, [&](auto xt) {
      dispatch_chunks(static_cast<const int*>(row_ptr),
                      static_cast<const int*>(col),
                      static_cast<const float*>(val), xt,
                      static_cast<float*>(out), n_rows, F, K,
                      static_cast<cudaStream_t>(stream));
    });
  }
  return static_cast<int>(cudaGetLastError());
}
