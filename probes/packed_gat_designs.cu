// Design probe of the packed-GAT forward and backward
// (pytorch_geometric_tpu_torch/csrc/packed_gat.cu), built and timed by
// probes/packed_gat_designs.py. Not part of the port.
//
// The production source is included. Its forward and backward each have
// two designs: the row map (gat_fwd_rows_kernel, gat_bwd_kernel: one
// sub-warp per CSR row over all heads, each edge's index and terms loaded
// once, whole-row gathers), which packed_gat_fwd and packed_gat_bwd
// launch wherever its lane map covers a row in one pass; and the source's
// first design (gat_fwd_kernel, gat_bwd_heads_kernel: one group of lanes
// per (row, head) walking the row's edges one after another), which the
// library keeps for the other widths. first_packed_gat_fwd and
// first_packed_gat_bwd launch the first design at every width with the
// library's signatures, so one run times both designs on the same
// inputs, and nvcc's -Xptxas -v report of this source gives the
// registers and spills of both.

#include "../pytorch_geometric_tpu_torch/csrc/packed_gat.cu"

// The first design's forward: packed_gat_fwd's arguments.
extern "C" int first_packed_gat_fwd(void* row_ptr, void* col, void* d,
                                    void* s, void* h, void* m, void* seed,
                                    void* out, int n_rows, int H, int C,
                                    unsigned thresh, float scale,
                                    float slope, void* stream) {
  if (n_rows > 0 && H > 0 && C > 0) {
    return launch_fwd_first(
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
