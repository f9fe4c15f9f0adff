"""The least time each of the port's CUDA kernels could take for one call
on the card: ``(ms, "bytes" or "operations")`` from
:func:`profiling.bound_ms`, the larger of the bytes the call must move
(each input read once, each output written once) over the memory rate
and its fp32 operations over the fp32 rate. Work that depends on the data
is counted for the data given (valid mask entries, rows of xB that some
edge names), never for the most it could be."""

import torch

from pytorch_geometric_tpu_torch.profiling import (
    BF16_FLOP_PER_S, FP32_FLOP_PER_S, HBM_BYTES_PER_S, bound_ms)


def spmm_bound(csr, f, x_bytes):
    """One ``spmm_csr`` call: the CSR (column and weight per edge, a
    pointer per row), the rows of x that some edge names once at
    ``x_bytes`` per element (a column no edge names need not be read: a
    rectangular operator's transpose names a fifth of its 1 M columns),
    the fp32 output once; 2 flops per edge and feature."""
    used = int(torch.unique(csr.col).numel())
    nbytes = (csr.num_edges * 8 + (csr.num_rows + 1) * 4
              + used * f * x_bytes + csr.num_rows * f * 4)
    return bound_ms(nbytes, 2 * csr.num_edges * f)


def gat_bound(op, H, C, backward):
    """One packed-GAT call (both backward walks): the edge set once
    (row_ptr and col of one CSR), the node inputs once (d, s, h, seed;
    the shift's (N, H) m and g for the backward), the outputs once
    (num‖den and m; dd, ds, dh), fp32. Flops per (edge, head): forward 2C
    (weighted sum) + 9 (the max, logit, leaky, shift, exp, denominator,
    dropout scale), backward 4C (the dot <gnum, h> and dh) + 12 (the same
    logit terms and dz)."""
    n, E, HC = op.n, op.E, H * C
    nbytes = ((n + 1) * 4 + E * 4
              + (2 * n * H + n * HC + 1) * 4
              + n * H * 4                           # m, out or in
              + n * (HC + H) * 4)                   # out, or g
    if backward:
        nbytes += (2 * n * H + n * HC) * 4          # dd, ds, dh
        flops = E * H * (4 * C + 12)
    else:
        flops = E * H * (2 * C + 9)
    return bound_ms(nbytes, flops)


def gat_walk_bound(op, H, C, walk):
    """One walk of the packed-GAT backward: its CSR once (walk 1 with its
    edge ids), d, s, h, the (N, H) m, the seed and g once, its outputs
    once (walk 0: dd; walk 1: ds and dh), fp32. Flops per (edge, head):
    walk 0 2C (the dot) + 12, walk 1 4C (the dot and dh) + 12."""
    n, E, HC = op.n, op.E, H * C
    nbytes = ((n + 1) * 4 + E * (8 if walk else 4)
              + (3 * n * H + n * HC + 1) * 4 + n * (HC + H) * 4
              + (n * (H + HC) if walk else n * H) * 4)
    return bound_ms(nbytes, E * H * ((4 if walk else 2) * C + 12))


def gat_gather_bytes(op, H, C):
    """Bytes one gathering walk of the packed GAT moves through L2: every
    edge of ``op`` gathers its neighbour's slice of one (N, H C) fp32 array
    (h[src] in the forward and walk 0, gnum[dst] in walk 1), E H C 4. Not
    a bound: the byte bound (:func:`gat_bound`) reads each node row once,
    and this counts what a kernel that gathers a row per edge reads again
    from L2 (the forward one walk, the backward two)."""
    return op.E * H * C * 4


def flash_gat_bound(n, valid, H, C, backward):
    """One dense-mask flash-GAT call on an (n, n) mask with ``valid`` true
    entries: the mask once at one bit per entry (the least any dense-mask
    operator reads, whatever layout it keeps), the node inputs once (d, s,
    h, seed; lse, out and g for the backward), the outputs once (out, lse;
    dd, ds, dh), fp32. Flops per valid (entry, head) as :func:`gat_bound`
    counts them: what this mask needs, not the n^2 positions a dense walk
    would visit."""
    HC = H * C
    nbytes = n * n // 8 + (2 * n * H + n * HC + 1) * 4
    if backward:
        nbytes += (n * H + 2 * n * HC) * 4          # lse, out, g
        nbytes += (2 * n * H + n * HC) * 4          # dd, ds, dh
        flops = valid * H * (4 * C + 12)
    else:
        nbytes += (n * HC + n * H) * 4              # out, lse
        flops = valid * H * (2 * C + 8)
    return bound_ms(nbytes, flops)


def bsr_gat_bound(n, valid, H, C, kernel):
    """One block-sparse GAT launch (``kernel``: "fwd", "bwd_row" or
    "bwd_col") on a mask of ``valid`` entries: the entry set once at 4
    bytes per entry plus a pointer per row (the count of
    :func:`gat_bound`, so it follows no tile), the node inputs and the
    outputs once, fp32. Flops per (entry, head): forward 2C + 8, the row
    pass 2C + 12 (the dot <g, h> and dz), the column pass 4C + 12 (the
    dot and dh)."""
    HC = H * C
    nbytes = valid * 4 + (n + 1) * 4 + (2 * n * H + n * HC + 1) * 4
    if kernel == "fwd":
        nbytes += (n * HC + n * H) * 4                  # out, lse
        flops = valid * H * (2 * C + 8)
    elif kernel == "bwd_row":
        nbytes += (n * H + 2 * n * HC) * 4              # lse, out, g
        nbytes += 2 * n * H * 4                         # dd, D
        flops = valid * H * (2 * C + 12)
    else:
        nbytes += (2 * n * H + n * HC) * 4              # lse, D, g
        nbytes += (n * H + n * HC) * 4                  # ds, dh
        flops = valid * H * (4 * C + 12)
    return bound_ms(nbytes, flops)


def rgcn_bound(op, B, C, backward):
    """One packed-RGCN call: the edge set once (row_ptr, col, relation
    and weight of one CSR), att and the rows of xB that some edge names
    once (rows no edge sends from, such as padding rows, need not be
    read), and the output once (forward) or g and both gradients once
    (backward; every row of dxB is written), fp32. Flops per edge: 2 B C
    forward (the contraction over bases), 4 B C backward (dxB and the
    dots of datt)."""
    rows, n, E, R = op.num_src_rows, op.num_nodes, op.E, op.R
    used = int(torch.unique(op.fwd.col).numel())
    nbytes = ((n + 1) * 4 + E * 12 + used * B * C * 4 + R * B * 4
              + n * C * 4)                          # out, or g
    if backward:
        nbytes += rows * B * C * 4 + R * B * 4      # dxB, datt
    return bound_ms(nbytes, E * B * C * (4 if backward else 2))


def segment_sum_bound(num_rows, num_edges, f, msg_bytes):
    """One sorted segment sum: the messages once, the row pointers once,
    the fp32 output once; one add per message element."""
    nbytes = (num_edges * f * msg_bytes + (num_rows + 1) * 4
              + num_rows * f * 4)
    return bound_ms(nbytes, num_edges * f)


def fused_gcn_bound(n, num_edges, H, C, backward):
    """One fused two-layer GCN call (one direction): the CSR once (column
    and weight per edge, a pointer per row), the input (z1, or g2), W2, b1
    and the seed once, h1_pre once in the backward, the two outputs
    (h1_pre and out; gA2 and dz1) and the scratch (z2; dh1) written once,
    fp32. Not counted: the CSR's second walk and the scratch read back,
    which are the design's. Flops: 2 per edge and feature in each
    aggregation (H and C wide), 2 H C per node in the per-node step."""
    csr = num_edges * 8 + (n + 1) * 4
    params = (H * C + H + 1) * 4
    if backward:
        nbytes = csr + params + n * (C + H) * 4 + n * (C + 2 * H) * 4
    else:
        nbytes = csr + params + n * H * 4 + n * (H + 2 * C) * 4
    return bound_ms(nbytes, 2 * num_edges * (H + C) + 2 * n * H * C)


def block_spmm_bound(op, f, direction="fwd"):
    """One ``BlockSpmm`` call (``fn(consts, x)``, or its ``dx``) as the
    block design does the work: the (B, W, W) table once and its products
    at the tensor-core rate of its type (2 B W² F), the remainder's CSR as
    :func:`spmm_bound` counts it (its x rows in the compute type), x (or
    g) read and the output written once in fp32; the x rows the
    products read are counted once."""
    st = op.structure
    W, B, N = st.window, st.num_dense_blocks, st.num_nodes
    elem = torch.tensor([], dtype=st.compute_dtype).element_size()
    t_bytes = (B * W * W * elem + 2 * N * f * 4) / HBM_BYTES_PER_S
    dense_flops = 2 * B * W * W * f
    rate = BF16_FLOP_PER_S if st.compute_dtype == torch.bfloat16 \
        else FP32_FLOP_PER_S
    t_ops = dense_flops / rate
    if st.sparse is not None:
        csr = st.sparse.fwd if direction == "fwd" else st.sparse.bwd
        used = int(torch.unique(csr.col).numel())
        t_bytes += (csr.num_edges * 8 + (csr.num_rows + 1) * 4
                    + used * f * elem) / HBM_BYTES_PER_S
        t_ops += 2 * csr.num_edges * f / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
