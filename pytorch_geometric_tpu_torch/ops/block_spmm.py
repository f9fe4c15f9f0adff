"""Block-sparse-row SpMM: dense (window, window) blocks and a sparse
remainder, for graphs of 100M edges.

Counterpart of ``pytorch_geometric_tpu/ops/block_spmm.py``. After a
locality ordering a community-structured graph puts most of its edges in
a few (destination window, source window) blocks dense enough that a
matrix product over the whole block beats any per-edge format. The split
is the JAX package's, on the host, and depends on the graph only
(:class:`BlockStructure`, shared by several weightings):

- the edge keys ``dst window · nw + src window`` counted by a bincount
  over the ``nw²`` keys; keys of at least ``dense_threshold`` edges are
  the dense blocks, sorted by key, so by destination window;
- each dense edge's slot in the (B, W, W) table,
  ``(block · W + r % W) · W + s % W``;
- the other edges, the remainder: an ``SpmmOperator`` (the ``spmm_csr``
  kernel; bf16 x by default).

The table (:meth:`BlockStructure.dense_blocks`) is built on the device
with no atomics: the dense edges sorted by slot once (weight-free, at
construction), then, per weight vector, the segment-sum kernel over
equal slots (duplicate edges sum in fp32, in edge order) and one
rounding to ``compute_dtype``. The JAX build's bipartite identity SpMM
would gather a W-wide identity row per edge, W times the bytes; its SMEM
chunking is a TPU device.

:meth:`BlockSpmm.bind` returns ``(fn, consts)``; ``fn(consts, x)`` is
differentiable in x. The dense part pads x to ``nw · W`` rows in the
compute type, gathers each block's source window, multiplies by the
blocks (``torch.bmm``: cuBLAS, as the JAX package leaves its einsum to
XLA) with fp32 output, and sums the products over destination windows
through the segment-sum kernel (rows of W·F). Its backward gathers the
cotangent's destination windows in the compute type, multiplies by the
transposed blocks and sums by source window through the same kernel.
The remainder adds ``SpmmOperator.bind_external``'s result and ``dx``.
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import build_csr, host_array
from pytorch_geometric_tpu_torch.ops.sorted_spmm import sorted_segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator


def _cdiv(a, b):
    return -(-a // b)


def _f32_to_bf16(a) -> torch.Tensor:
    """Round-to-nearest-even float32 -> bfloat16 (torch's conversion;
    the JAX package's integer-view rounding gives the same bits)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return a.to(torch.bfloat16)


def _bmm_f32(a, b):
    """``a @ b`` over the batch with fp32 output: the products of the
    (bf16 or fp32) values summed in fp32, as the JAX einsum's
    ``preferred_element_type=float32``. On the card bf16 inputs keep
    bf16 tensor-core rate (``out_dtype``); on the CPU the values are
    widened first, the same function."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class BlockStructure:
    """Weight-independent packing for :class:`BlockSpmm`: the bucket
    counts, the dense-block split, the dense edges in slot order with
    the segments of equal slots, the remainder's operator. ``device`` is
    where the tables and the operator live; the host keeps only the edge
    ids of the remainder."""

    def __init__(self, senders, receivers, num_nodes, *,
                 window: int = 1024, dense_threshold: int = 1024,
                 compute_dtype=torch.bfloat16, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                            f"got {compute_dtype}")
        senders = host_array(senders).astype(np.int64, copy=False)
        receivers = host_array(receivers).astype(np.int64, copy=False)
        E = senders.shape[0]
        N = int(num_nodes)
        self.num_nodes = N
        self.window = window
        self.compute_dtype = compute_dtype
        self.device = dev
        nw = max(_cdiv(N, window), 1)
        self.num_windows = nw

        # O(E) detection: a bincount over the nw*nw keys (the JAX code's)
        s32 = senders.astype(np.int32, copy=False)
        r32 = receivers.astype(np.int32, copy=False)
        key = (r32 // window) * np.int32(nw) + (s32 // window)
        counts = np.bincount(key, minlength=nw * nw) if E else \
            np.zeros(nw * nw, np.int64)
        dense_keys = np.flatnonzero(counts >= dense_threshold) if E \
            else np.zeros(0, np.int64)
        dense_mask = (counts >= dense_threshold)[key] if E else \
            np.zeros(0, bool)
        self.dense_edge_frac = float(dense_mask.mean()) if E else 0.0
        B = len(dense_keys)
        self.num_dense_blocks = B

        if B:
            ei = np.flatnonzero(dense_mask)
            b_of = np.searchsorted(dense_keys, key[ei])
            flat = ((b_of.astype(np.int64) * window + r32[ei] % window)
                    * window + s32[ei] % window)
            # the dense edges in slot order (a stable sort: a slot's
            # duplicate edges keep their edge order), and the slots'
            # segments, for the table's segment sum
            flat = torch.from_numpy(flat).to(dev)
            flat, order = torch.sort(flat, stable=True)
            self._dense_edge_ids = torch.from_numpy(ei).to(dev)[order]
            self._slots, seg = torch.unique_consecutive(flat,
                                                        return_counts=True)
            row_ptr = torch.zeros(seg.shape[0] + 1, dtype=torch.int64,
                                  device=dev)
            torch.cumsum(seg, 0, out=row_ptr[1:])
            self._slot_ptr = row_ptr.to(torch.int32)
            bsw = (dense_keys % nw).astype(np.int64)
            bdw = (dense_keys // nw).astype(np.int64)
            self.block_src_win = torch.from_numpy(bsw).to(dev)
            self.block_dst_win = torch.from_numpy(bdw).to(dev)
            # the sums over windows: by destination window (the blocks'
            # own order, their keys being sorted) and by source window
            # (a permutation of them)
            zeros = np.zeros(B, np.int64)
            by_dst = build_csr(bdw, zeros, nw)
            assert torch.equal(by_dst.perm, torch.arange(B))
            self._dst_ptr = by_dst.row_ptr.to(dev)
            by_src = build_csr(bsw, zeros, nw).to(dev)
            self._src_ptr, self._src_perm = by_src.row_ptr, by_src.perm

        sparse_idx = np.flatnonzero(~dense_mask)
        self.sparse_edges = len(sparse_idx)
        self._sparse_edge_ids = sparse_idx
        self.sparse = None
        if len(sparse_idx):
            self.sparse = SpmmOperator(
                senders[sparse_idx], receivers[sparse_idx], N,
                compute_dtype=compute_dtype, device=dev)

    @property
    def flop_inflation(self) -> float:
        """1.0: a CSR has no tile padding (the JAX remainder's packed
        tiles pad each bucket to whole tiles)."""
        return 1.0

    def dense_blocks(self, weights) -> torch.Tensor:
        """(B, window, window) table in ``compute_dtype`` on the device for
        one weight vector (edge order): ``table[b, r % W, s % W]`` the sum
        of the block's edges (r, s), in fp32 and in edge order, rounded
        once. One segment-sum launch (F = 1) over the slots."""
        W, B = self.window, self.num_dense_blocks
        if isinstance(weights, torch.Tensor):
            w = weights.detach().to(device=self.device, dtype=torch.float32)
        else:
            w = torch.from_numpy(np.asarray(weights, np.float32)).to(
                self.device)
        sums = sorted_segment_sum(self._slot_ptr,
                                  w[self._dense_edge_ids][:, None])
        table = torch.zeros(B * W * W, dtype=self.compute_dtype,
                            device=self.device)
        vals = sums[:, 0] if self.compute_dtype == torch.float32 else \
            _f32_to_bf16(sums[:, 0])
        table[self._slots] = vals
        return table.reshape(B, W, W)


class BlockSpmm:
    """``out[r] = sum_e w_e x[s_e]`` with static weights, at 100M-edge
    scale.

    Usage::

        op = BlockSpmm(senders, receivers, num_nodes, weights)
        fn, consts = op.bind()
        out = fn(consts, x)            # differentiable in x

    Pass ``structure=`` (a :class:`BlockStructure` of the same graph) to
    share the packing between weightings: the construction then costs
    the table's segment sum and the remainder's routing."""

    def __init__(self, senders, receivers, num_nodes, weights, *,
                 window: int = 1024, dense_threshold: int = 1024,
                 compute_dtype=torch.bfloat16,
                 structure: BlockStructure = None, device="cuda"):
        if structure is None:
            structure = BlockStructure(
                senders, receivers, num_nodes, window=window,
                dense_threshold=dense_threshold,
                compute_dtype=compute_dtype, device=device)
        st = structure
        self.structure = st
        self.num_nodes = st.num_nodes
        self.window = st.window
        self.num_windows = st.num_windows
        self.dense_edge_frac = st.dense_edge_frac
        self.num_dense_blocks = st.num_dense_blocks
        self.sparse_edges = st.sparse_edges
        self._sparse = st.sparse
        self._compute = st.compute_dtype

        weights = host_array(weights).astype(np.float32, copy=False)
        consts: Dict[str, Any] = {}
        if st.num_dense_blocks:
            consts["blocks"] = st.dense_blocks(weights)
            consts["bsw"] = st.block_src_win
            consts["bdw"] = st.block_dst_win
        if st.sparse is not None:
            sp_fn, sp_consts = st.sparse.bind_external(
                weights[st._sparse_edge_ids])
            self._sp_fn = sp_fn
            consts["sparse"] = sp_consts
        self._consts = consts

    @property
    def flop_inflation(self) -> float:
        return self.structure.flop_inflation

    def bind(self) -> Tuple[Any, Dict[str, Any]]:
        """Returns ``(fn, consts)``; ``fn(consts, x)`` differentiable in
        x, fp32 out."""
        st, N = self.structure, self.num_nodes
        has_dense = self.num_dense_blocks > 0
        sp_fn = self._sp_fn if self._sparse is not None else None

        def fn(consts, x):
            out = None
            if has_dense:
                out = _BlockDense.apply(x, consts["blocks"], consts["bsw"],
                                        consts["bdw"], st)
            if sp_fn is not None:
                sp = sp_fn(consts["sparse"], x)
                out = sp if out is None else out + sp
            if out is None:
                out = torch.zeros((N, x.shape[1]), dtype=torch.float32,
                                  device=x.device)
            return out

        return fn, self._consts


def _windows(x, st: BlockStructure):
    """x (N, F) padded to ``nw · W`` rows in the compute type, as
    (nw, W, F)."""
    W, nw, N = st.window, st.num_windows, st.num_nodes
    xw = torch.zeros((nw * W, x.shape[1]), dtype=st.compute_dtype,
                     device=x.device)
    xw[:N] = x.to(st.compute_dtype)
    return xw.reshape(nw, W, x.shape[1])


def _window_sum(row_ptr, parts, st: BlockStructure, perm=None):
    """The (B, W, F) fp32 ``parts`` summed by window: the blocks taken in
    ``perm`` order (None: their own) group under the window segments of
    ``row_ptr``. (N, F)."""
    B, W, F = parts.shape
    flat = parts.reshape(B, W * F)
    if perm is not None:
        flat = flat.index_select(0, perm)
    out = sorted_segment_sum(row_ptr, flat)
    return out.reshape(st.num_windows * W, F)[:st.num_nodes]


class _BlockDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blocks, bsw, bdw, st):
        ctx.st, ctx.x_dtype = st, x.dtype
        ctx.save_for_backward(blocks, bdw)
        xs = _windows(x, st).index_select(0, bsw)         # (B, W, F)
        return _window_sum(st._dst_ptr, _bmm_f32(blocks, xs), st)

    @staticmethod
    def backward(ctx, g):
        st = ctx.st
        blocks, bdw = ctx.saved_tensors
        gs = _windows(g, st).index_select(0, bdw)         # (B, W, F)
        prods = _bmm_f32(blocks.transpose(1, 2), gs)
        dx = _window_sum(st._src_ptr, prods, st, st._src_perm)
        return dx.to(ctx.x_dtype), None, None, None, None
