"""Fused RGCN aggregation: basis-decomposed relational message passing
in one kernel forward, and its backward.

Counterpart of ``pytorch_geometric_tpu/ops/packed_rgcn.py``
(``PackedRgcnSpmm``), with the same call contract: per edge e (src ->
recv, relation et, static mean-norm weight w),

    out[i] = sum_{e -> i} w_e * sum_b att[et_e, b] * xB[src_e, b, :]

and, backward, ``dxB`` scattered to senders and ``datt`` reduced into the
(R, B) table. The JAX package packs edges into (sender window, receiver
window) tiles for the TPU's one-hot matrix products; its ``window``,
``tile``, ``onehot``, ``out_t`` and ``interpret`` options have no
counterpart here. The host builds two CSRs of one edge list, each with
its relation and weight per edge: receiver-major and sender-major, plus
each sender-major edge's position in receiver-major order (where the
forward's messages are summed) and in relation-major order (where
``datt`` is reduced without atomics). Duplicate edges are kept: each
counts, as in ``rgcn_norm``.

:func:`packed_rgcn_fwd` and :func:`packed_rgcn_bwd` wrap the hand-written
CUDA kernels of ``csrc/packed_rgcn.cu``, which replace the Pallas kernels
``ops/packed_rgcn.py:_fwd_kernel`` and ``_bwd_kernel``. The forward is
two launches: each edge's message from the sender-major walk, which
reads each ``xB`` row once, then the receiver-sorted segment sum
(``csrc/segment_sum.cuh``). Beside the wrappers: their plain PyTorch
versions (the forward's also as its two phases,
:func:`packed_rgcn_messages_plain` and ``sorted_segment_sum_plain``) and
``.launches``, a count of kernel launches. A wrapper takes its plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernels, or raises. Storage and sums are fp32 (the JAX kernel rounds
``xB``, ``att`` and ``g`` to bf16).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import (
    Csr, build_csr, host_array)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    sorted_segment_sum_plain)

#: Parts that each relation's edge range is cut into for the ``datt``
#: reduction (one block each), so a relation holding most edges is spread
#: over this many blocks.
DATT_SPLITS = 32


class SenderCsr(NamedTuple):
    """The sender-major CSR of an operator's edges as the forward's
    message walk reads it: ``csr`` (rows = senders, ``col`` = receiver),
    ``et`` (int32) and ``w`` (float32) per edge in its order, and ``pos``
    (int32), each edge's position in the receiver-major CSR."""
    csr: Csr
    et: torch.Tensor
    w: torch.Tensor
    pos: torch.Tensor


def _rows_of(csr: Csr):
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(csr.num_rows, device=csr.col.device), counts,
        output_size=csr.num_edges)    # known size: no device sync


def packed_rgcn_fwd_plain(csr: Csr, et, w, xB, att):
    """``out`` (num_rows, C) over the receiver-major ``csr`` (``col`` =
    sender; ``et`` and ``w`` in CSR order), in plain PyTorch: the
    kernel's reference."""
    B = att.shape[1]
    C = xB.shape[1] // B
    ae = att[et.long()]                                      # (E, B)
    xbe = xB[csr.col.long()].view(-1, B, C)                  # (E, B, C)
    msg = (ae[:, :, None] * xbe).sum(1) * w[:, None]         # (E, C)
    out = torch.zeros((csr.num_rows, C), dtype=torch.float32,
                      device=xB.device)
    return out.index_add_(0, _rows_of(csr), msg)


def packed_rgcn_messages_plain(send: SenderCsr, xB, att):
    """The forward's first phase in plain PyTorch: each edge's message
    ``w_e * sum_b att[et_e, b] * xB[sender_e, b, :]``, (E, C), at its
    receiver-major position ``send.pos``; summed per receiver by
    ``sorted_segment_sum_plain``, it is ``packed_rgcn_fwd_plain``."""
    B = att.shape[1]
    C = xB.shape[1] // B
    ae = att[send.et.long()]                                 # (E, B)
    xbe = xB[_rows_of(send.csr)].view(-1, B, C)              # (E, B, C)
    msg = (ae[:, :, None] * xbe).sum(1) * send.w[:, None]    # (E, C)
    out = torch.empty_like(msg)
    out[send.pos.long()] = msg
    return out


def packed_rgcn_bwd_plain(csr: Csr, et, w, xB, att, g):
    """``(dxB, datt)`` from ``g``, the gradient of ``out``, over the
    sender-major ``csr`` (``col`` = receiver; ``et`` and ``w`` in CSR
    order), in plain PyTorch: the kernels' reference."""
    R, B = att.shape
    C = xB.shape[1] // B
    send = _rows_of(csr)
    ge = g[csr.col.long()] * w[:, None]                      # (E, C)
    ae = att[et.long()]                                      # (E, B)
    dxB = torch.zeros((csr.num_rows, B * C), dtype=torch.float32,
                      device=xB.device)
    dxB.index_add_(0, send, (ae[:, :, None] * ge[:, None, :])
                   .reshape(-1, B * C))
    dae = (xB[send].view(-1, B, C) * ge[:, None, :]).sum(2)  # (E, B)
    datt = torch.zeros((R, B), dtype=torch.float32, device=xB.device)
    return dxB, datt.index_add_(0, et.long(), dae)


def _check(csr: Csr, et, w, xB, att, src_rows, g=None, ints=()):
    """Validate one call over ``csr`` (sender-major in both directions);
    returns (R, B, C, device). ``src_rows`` is the row count ``xB`` must
    have (the CSR's rows, the senders); ``g`` and ``out`` have the other
    count."""
    if att.ndim != 2 or xB.ndim != 2 or att.shape[1] == 0 \
            or xB.shape[1] % att.shape[1] or xB.shape[1] == 0:
        raise ValueError(f"att must be (R, B) and xB (rows, B*C), got "
                         f"{tuple(att.shape)}, {tuple(xB.shape)}")
    R, B = att.shape
    C = xB.shape[1] // B
    E = csr.num_edges
    # with none of these empty, every call launches each of its kernels
    if R == 0 or csr.num_rows == 0 or csr.num_cols == 0:
        raise ValueError(f"packed RGCN needs at least one relation, row "
                         f"and column, got R={R}, a {csr.num_rows} x "
                         f"{csr.num_cols} CSR")
    if xB.shape[0] != src_rows:
        raise ValueError(f"xB must have {src_rows} rows, got {xB.shape[0]}")
    if et.shape != (E,) or w.shape != (E,):
        raise ValueError(f"et and w must be ({E},), got {tuple(et.shape)}, "
                         f"{tuple(w.shape)}")
    floats = [w, xB, att] + ([] if g is None else [g])
    for t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("w, xB, att and g must be contiguous float32")
    for t in (csr.row_ptr, csr.col, et, *ints):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("row_ptr, col, et, pos and rel_ptr must be "
                            "contiguous int32")
    if g is not None and g.shape != (csr.num_cols, C):
        raise ValueError(f"g must be ({csr.num_cols}, {C}), got "
                         f"{tuple(g.shape)}")
    devices = {t.device for t in floats + [csr.row_ptr, csr.col, et, *ints]}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed RGCN runs on cpu or cuda, not {device}")
    return R, B, C, device


def _check_send(csr: Csr, send: SenderCsr):
    """``send`` must be the sender-major CSR of ``csr``'s edges."""
    if not isinstance(send, SenderCsr):
        raise TypeError(f"send must be a SenderCsr, got {type(send)}")
    sc = send.csr
    if (sc.num_rows, sc.num_cols, sc.num_edges) != (
            csr.num_cols, csr.num_rows, csr.num_edges):
        raise ValueError(
            f"send must be the sender-major CSR of the same edges: a "
            f"{csr.num_cols} x {csr.num_rows} CSR of {csr.num_edges} edges, "
            f"got {sc.num_rows} x {sc.num_cols} of {sc.num_edges}")
    if send.pos.shape != (sc.num_edges,):
        raise ValueError(f"send.pos must be ({sc.num_edges},), got "
                         f"{tuple(send.pos.shape)}")
    if csr.row_ptr.device != sc.row_ptr.device:
        raise ValueError(f"csr and send must share one device, got "
                         f"{csr.row_ptr.device} and {sc.row_ptr.device}")


def packed_rgcn_fwd(csr: Csr, send: SenderCsr, xB, att):
    """``out`` (num_rows, C) over the receiver-major ``csr``: on CUDA
    tensors two launches (each edge's message from the sender-major walk
    of ``send``, which reads each ``xB`` row once, into an (E, C)
    scratch; then the receivers' sums over ``csr.row_ptr`` in CSR order);
    on CPU tensors the same two phases in plain PyTorch. ``xB`` is
    (num_cols, B*C), ``att`` (R, B); ``send`` holds the sender-major CSR
    of the same edges with their relation, weight and receiver-major
    position (``PackedRgcnSpmm.send``)."""
    _check_send(csr, send)
    R, B, C, device = _check(send.csr, send.et, send.w, xB, att,
                             csr.num_cols, ints=(send.pos, csr.row_ptr))
    if device.type == "cpu":
        return sorted_segment_sum_plain(
            csr.row_ptr, packed_rgcn_messages_plain(send, xB, att))
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("packed_rgcn")
    # scratch: each edge's message, in receiver-major order
    msg = torch.empty((csr.num_edges, C), dtype=torch.float32, device=device)
    out = torch.empty((csr.num_rows, C), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.packed_rgcn_fwd(
            csr.row_ptr.data_ptr(), send.csr.row_ptr.data_ptr(),
            send.et.data_ptr(), send.w.data_ptr(), send.pos.data_ptr(),
            xB.data_ptr(), att.data_ptr(), msg.data_ptr(), out.data_ptr(),
            csr.num_rows, send.csr.num_rows, R, B, C, stream)
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    packed_rgcn_fwd.launches += 2
    return out


def packed_rgcn_bwd(csr: Csr, et, w, pos, rel_ptr, xB, att, g):
    """``(dxB, datt)``: on CUDA tensors three launches (the backward
    kernel over the sender-major ``csr``, then the two steps of the
    ``datt`` reduction); on CPU tensors the plain version. ``col`` is the
    receiver's row of ``g`` (num_cols, C); ``pos`` (int32, CSR order) is
    each edge's position in relation-major order and ``rel_ptr`` (R + 1,
    int32) the relations' ranges there."""
    R, B, C, device = _check(csr, et, w, xB, att, csr.num_rows, g,
                             ints=(pos, rel_ptr))
    E = csr.num_edges
    if pos.shape != (E,) or rel_ptr.shape != (R + 1,):
        raise ValueError(f"pos must be ({E},) and rel_ptr ({R + 1},), got "
                         f"{tuple(pos.shape)}, {tuple(rel_ptr.shape)}")
    if R > 65535:
        raise ValueError("more than 65535 relations: beyond the datt "
                         "reduction's grid")
    if device.type == "cpu":
        return packed_rgcn_bwd_plain(csr, et, w, xB, att, g)
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("packed_rgcn")
    dxB = torch.empty((csr.num_rows, B * C), dtype=torch.float32,
                      device=device)
    datt = torch.empty((R, B), dtype=torch.float32, device=device)
    # scratch: per-edge attention gradients, and the reduction's parts
    dae = torch.empty((E, B), dtype=torch.float32, device=device)
    partial = torch.empty((R, DATT_SPLITS, B), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.packed_rgcn_bwd(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), et.data_ptr(),
            w.data_ptr(), pos.data_ptr(), rel_ptr.data_ptr(), xB.data_ptr(),
            att.data_ptr(), g.data_ptr(), dxB.data_ptr(), datt.data_ptr(),
            dae.data_ptr(), partial.data_ptr(), csr.num_rows, R, B, C,
            DATT_SPLITS, stream)
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    packed_rgcn_bwd.launches += 3
    return dxB, datt


#: Launches of the CUDA kernels; the CPU path never adds to them. The
#: forward counts each of its two launches, the backward its three.
packed_rgcn_fwd.launches = 0
packed_rgcn_bwd.launches = 0


class PackedRgcnSpmm:
    """Relational basis aggregation over one static edge list.

    Built once per graph and layer on the host; every array lives on
    ``device``. Same call contract as the JAX operator::

        op = PackedRgcnSpmm(senders, receivers, edge_type, R, N, norm)
        out = op(xB2d, att)     # xB2d (num_src_rows, B*C), att (R, B)

    Senders are clipped to ``num_src_rows - 1``.
    """

    def __init__(self, senders, receivers, edge_type, num_relations: int,
                 num_nodes: int, weights, num_src_rows: Optional[int] = None,
                 device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        s = host_array(senders).astype(np.int64)
        r = host_array(receivers).astype(np.int64)
        et = host_array(edge_type).astype(np.int64)
        w = host_array(weights).astype(np.float32)
        self.num_nodes = int(num_nodes)
        self.num_src_rows = int(num_src_rows if num_src_rows is not None
                                else num_nodes)
        self.R = int(num_relations)
        self.E = int(s.shape[0])
        self.device = dev
        if not (s.shape == r.shape == et.shape == w.shape) or s.ndim != 1:
            raise ValueError("senders, receivers, edge_type and weights "
                             "must be 1-D of one length")
        if et.size and (et.min() < 0 or et.max() >= self.R):
            raise ValueError(f"edge_type out of range [0, {self.R})")
        s = np.clip(s, 0, self.num_src_rows - 1)

        def per_edge(csr):
            perm = csr.perm.numpy()
            return (torch.from_numpy(et[perm].astype(np.int32)).to(dev),
                    torch.from_numpy(w[perm]).to(dev))

        fwd = build_csr(r, s, self.num_nodes, self.num_src_rows)
        bwd = build_csr(s, r, self.num_src_rows, self.num_nodes)
        self.fwd_et, self.fwd_w = per_edge(fwd)
        self.bwd_et, self.bwd_w = per_edge(bwd)
        # relation-major order (stable): rank[e] is edge e's position there
        rank = np.empty(self.E, np.int64)
        rank[np.argsort(et, kind="stable")] = np.arange(self.E)
        self.bwd_pos = torch.from_numpy(
            rank[bwd.perm.numpy()].astype(np.int32)).to(dev)
        # receiver-major order: fwd_rank[e] is edge e's CSR position there
        fwd_rank = np.empty(self.E, np.int64)
        fwd_rank[fwd.perm.numpy()] = np.arange(self.E)
        self.fwd_pos = torch.from_numpy(
            fwd_rank[bwd.perm.numpy()].astype(np.int32)).to(dev)
        rel_ptr = np.zeros(self.R + 1, np.int64)
        np.cumsum(np.bincount(et, minlength=self.R), out=rel_ptr[1:])
        self.rel_ptr = torch.from_numpy(rel_ptr.astype(np.int32)).to(dev)
        self.fwd, self.bwd = fwd.to(dev), bwd.to(dev)
        self.send = SenderCsr(self.bwd, self.bwd_et, self.bwd_w,
                              self.fwd_pos)

    def __call__(self, xB2d, att):
        return _PackedRgcn.apply(xB2d, att, self)


class _PackedRgcn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xB2d, att, op):
        xB2d, att = xB2d.contiguous(), att.contiguous()
        ctx.save_for_backward(xB2d, att)
        ctx.op = op
        return packed_rgcn_fwd(op.fwd, op.send, xB2d, att)

    @staticmethod
    def backward(ctx, g):
        xB2d, att = ctx.saved_tensors
        op = ctx.op
        dxB, datt = packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                                    op.rel_ptr, xB2d, att, g.contiguous())
        return dxB, datt, None
