"""Receiver-sorted segment-sum SpMM.

Counterpart of ``pytorch_geometric_tpu/ops/sorted_spmm.py``. The messages
are gathered and weighted outside the kernel, in receiver order, and one
kernel sums each receiver's run of messages:

1. :class:`SortedSpmm` — ``op(weights, x)`` gives
   ``out[r] = sum_{e: recv_e = r} w_e * x[s_e]``, differentiable in
   (weights, x). The forward gathers ``w[perm][:, None] * x[col]`` in CSR
   order (bf16 messages when ``compute_dtype`` is bf16, as the JAX
   ``_run``) and sums them with :func:`sorted_segment_sum`; ``dx`` is the
   same over the transposed CSR, ``dw_e = <g[recv_e], x[s_e]>`` plain
   PyTorch, as the JAX package leaves the gathers to XLA.
2. :class:`SortedSegmentSum` — ``op(msgs)`` for messages (E, ...) in
   edge order: ``msgs[perm]``, then the kernel; its VJP is
   ``g[receivers]``. Its transpose, ``op.gather(x)``, is ``x[receivers]``
   with the kernel as its VJP: a gather whose backward sums in a fixed
   order. ``entry_mask`` keeps a batch's real entries only in the CSR;
   :class:`StaticSegmentSum` holds it in buffers of a loader's budget.
3. :func:`sorted_segment_sum` — the wrapper of the hand-written CUDA
   kernel ``csrc/sorted_spmm.cu``, which replaces the Pallas kernel
   ``ops/sorted_spmm.py:_scatter_kernel``. Beside it:
   :func:`sorted_segment_sum_plain` (``index_add_`` over the row ids) and
   ``sorted_segment_sum.launches``.

``pack_sorted`` / ``SortedPack`` are not ported: their role (receiver
order and the slot -> edge-id map) is ``ops/csr.py:build_csr``'s
``row_ptr``, ``col`` and ``perm``. The TPU knobs ``tile``, ``rows`` and
``f_tile`` are not accepted.

The wrapper takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel, and raises if the build or the launch
fails: there is no fallback.
"""

import ctypes

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import (
    Csr, StaticCsr, build_csr, copy_into, host_array)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def sorted_segment_sum_plain(row_ptr, msgs):
    """``out[r] = sum_{p in row r} msgs[p]`` in fp32, in plain PyTorch
    (``index_add_`` over the row ids): the kernel's reference. On the CPU
    it sums the first ``row_ptr[-1]`` messages; on the card ``msgs`` must
    hold exactly that many (reading it would wait for the card)."""
    num_rows = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1]) if row_ptr.device.type == "cpu" \
        else msgs.shape[0]
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=msgs.device), counts,
        output_size=nnz)    # known size: no device sync
    out = torch.zeros((num_rows, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    return out.index_add_(0, rows, msgs[:nnz].float())


def _check(row_ptr, msgs):
    if row_ptr.dtype != torch.int32 or row_ptr.ndim != 1 \
            or not row_ptr.is_contiguous() or row_ptr.shape[0] < 1:
        raise TypeError("row_ptr must be contiguous 1-D int32 of R + 1 "
                        "entries")
    if msgs.ndim != 2:
        raise ValueError(f"msgs must be (E, F), got {tuple(msgs.shape)}")
    if msgs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msgs must be float32 or bfloat16, got "
                        f"{msgs.dtype}")
    if row_ptr.device != msgs.device:
        raise ValueError(f"row_ptr and msgs must share one device, got "
                         f"{row_ptr.device} and {msgs.device}")


def sorted_segment_sum(row_ptr, msgs):
    """Segment sum of CSR-ordered messages, fp32 out: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor. ``msgs`` (E, F), fp32
    or bf16, holds row r's messages at positions ``row_ptr[r]`` to
    ``row_ptr[r+1]``; E must equal ``row_ptr[-1]`` (not checked: reading
    it would wait for the card)."""
    _check(row_ptr, msgs)
    if msgs.device.type == "cpu":
        return sorted_segment_sum_plain(row_ptr, msgs)
    if msgs.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum runs on cpu or cuda, not "
                         f"{msgs.device}")
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("sorted_spmm")
    msgs = msgs.contiguous()
    num_rows = row_ptr.shape[0] - 1
    out = torch.empty((num_rows, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = lib.sorted_segment_sum(
            row_ptr.data_ptr(), msgs.data_ptr(), out.data_ptr(), num_rows,
            msgs.shape[1], int(msgs.dtype == torch.bfloat16),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA "
                           f"error {rc}")
    sorted_segment_sum.launches += 1
    return out


#: Launches of the CUDA kernel; the CPU path never adds to it.
sorted_segment_sum.launches = 0


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def _message_dtype(compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    return compute_dtype


class SortedSpmm:
    """``out[r] = sum_{e: recv_e = r} w_e x[s_e]`` over a fixed edge
    structure, differentiable in (weights, x).

    Built on the host once: a receiver-major CSR (``fwd``) and its
    transpose (``bwd``), moved to ``device``. ``compute_dtype=bf16``
    rounds the gathered messages to bf16 before the kernel sums them in
    fp32; the output is always fp32.
    """

    def __init__(self, senders, receivers, num_nodes, *,
                 compute_dtype=torch.float32, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.compute_dtype = _message_dtype(compute_dtype)
        s = host_array(senders)
        r = host_array(receivers)
        self.num_nodes = int(num_nodes)
        self.fwd = build_csr(r, s, self.num_nodes).to(dev)
        self.bwd = build_csr(s, r, self.num_nodes).to(dev)
        self.senders = torch.from_numpy(s.astype(np.int64)).to(dev)
        self.receivers = torch.from_numpy(r.astype(np.int64)).to(dev)

    def _run(self, csr: Csr, weights, x):
        """The JAX ``_run``: gather and weight the messages in CSR order,
        round them to the message type, sum them with the kernel."""
        msgs = weights.float()[csr.perm][:, None] * x.index_select(0, csr.col)
        return sorted_segment_sum(csr.row_ptr, msgs.to(self.compute_dtype))

    def __call__(self, weights, x):
        return _SortedApply.apply(weights, x, self)


class _SortedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, x, op):
        ctx.op = op
        ctx.save_for_backward(weights, x)
        return op._run(op.fwd, weights, x)

    @staticmethod
    def backward(ctx, g):
        weights, x = ctx.saved_tensors
        op = ctx.op
        dw = dx = None
        if ctx.needs_input_grad[1]:
            dx = op._run(op.bwd, weights, g.float()).to(x.dtype)
        if ctx.needs_input_grad[0]:
            dw = (g[op.receivers] * x[op.senders].float()).sum(-1)
            dw = dw.to(weights.dtype)
        return dw, dx, None


class SortedSegmentSum:
    """``out[r] = sum_{e: recv_e = r} msgs[e]`` of per-edge messages
    (E, ...) handed in edge order, differentiable: the VJP of a segment
    sum is the cotangent gathered at the receivers. For attention-style
    convs that build their messages on the device; ``receivers`` may be
    any segment ids (a conv's senders, for the backward of a gather by
    senders: :meth:`gather`).

    ``entry_mask`` (E,) builds the CSR over the entries it marks only (a
    batch's real edges or nodes); ``receivers`` keeps every entry, so
    the messages, the VJP ``g[receivers]`` and :meth:`gather`'s output
    stay (E, ...) in entry order. An entry left out must hand 0 to the
    rows that are read (the masked sums zero their padding messages):
    the kernel adds a row's messages in CSR order from 0, and adding +0.0
    changes no sum, so every such row is bitwise the full operator's,
    and the padding row holds no entry for one group of lanes to walk.
    :meth:`gather`'s VJP then sums the kept entries' cotangents only."""

    def __init__(self, receivers, num_nodes, *, compute_dtype=torch.float32,
                 entry_mask=None, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.compute_dtype = _message_dtype(compute_dtype)
        r = host_array(receivers)
        entries = None if entry_mask is None else \
            np.flatnonzero(host_array(entry_mask))
        self.num_nodes = int(num_nodes)
        self.csr = build_csr(r, np.zeros_like(r), self.num_nodes,
                             edges=entries).to(dev)
        self.receivers = torch.from_numpy(r.astype(np.int64)).to(dev)

    def __call__(self, msgs):
        return _SegSumApply.apply(msgs, self)

    def gather(self, x):
        """``x[receivers]`` in edge order, the transpose of the segment
        sum, differentiable: its VJP is this operator's segment sum, so
        the backward runs the kernel, in a fixed order (torch's gather
        backward scatters with atomics, whose order varies from run to
        run). ``x`` (N, ...)."""
        return _GatherApply.apply(x, self)

    def _sum(self, msgs):
        flat = msgs[self.csr.perm].reshape(self.csr.num_edges, -1)
        out = sorted_segment_sum(self.csr.row_ptr,
                                 flat.to(self.compute_dtype))
        return out.reshape((self.num_nodes,) + tuple(msgs.shape[1:]))


class StaticSegmentSum(SortedSegmentSum):
    """A :class:`SortedSegmentSum` of ``num_entries`` messages into
    ``num_rows`` rows in static buffers on ``device``, loaded in place
    from an operator of each batch (:meth:`load`), which a captured step
    reads. ``receivers`` holds every entry; the CSR holds the batch
    operator's entries (its ``entry_mask``'s, or all of them), which end
    at ``row_ptr[num_rows]``: the slots past them are never read
    (``ops/csr.py:StaticCsr``), and their ``perm`` 0 gathers a message
    that nothing sums."""

    def __init__(self, num_rows: int, num_entries: int, *,
                 compute_dtype=torch.float32, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.compute_dtype = _message_dtype(compute_dtype)
        self.num_nodes = int(num_rows)
        self.csr = StaticCsr.empty(self.num_nodes, self.num_nodes,
                                   num_entries, dev)
        self.receivers = torch.zeros(num_entries, dtype=torch.int64,
                                     device=dev)

    def load(self, op: SortedSegmentSum) -> "StaticSegmentSum":
        """Copy ``op`` (a batch's operator of as many rows and entries,
        over all of them or its real ones, on the host or the card) in on
        the current stream, without a host wait."""
        if (op.num_nodes, op.receivers.shape[0], op.compute_dtype) != (
                self.num_nodes, self.receivers.shape[0],
                self.compute_dtype):
            raise ValueError(f"a segment sum of {op.receivers.shape[0]} "
                             f"entries into {op.num_nodes} rows "
                             f"({op.compute_dtype}) does not fit static "
                             f"buffers of {self.receivers.shape[0]} into "
                             f"{self.num_nodes} ({self.compute_dtype})")
        self.csr.load(op.csr)
        copy_into(self.receivers, op.receivers)
        return self


class _SegSumApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, op):
        ctx.op, ctx.dtype = op, msgs.dtype
        return op._sum(msgs)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.op.receivers].to(ctx.dtype), None


class _GatherApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op, ctx.dtype = op, x.dtype
        return x.index_select(0, op.receivers)

    @staticmethod
    def backward(ctx, g):
        return ctx.op._sum(g).to(ctx.dtype), None
