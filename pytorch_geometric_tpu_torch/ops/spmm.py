"""SpMM — the hot op under every weighted aggregation.

Counterpart of ``pytorch_geometric_tpu/ops/spmm.py``:

1. ``spmm`` — the plain path: per-edge gather, weight, ``index_add_``.
2. ``SpmmOperator`` — bound to a fixed edge structure, built once per
   graph on the host. ``op(weights, x)`` is differentiable in weights and
   x; ``op.bind(weights)`` fixes static weights (GCN's normalised
   adjacency) and is differentiable in x; ``op.bind_external(weights)``
   does the same with the routed weights as an explicit argument.
   Forward and ``dx`` both run :func:`spmm_csr`, over the
   receiver-major CSR and over its transpose.
3. The static forms, with the routed weights as explicit arguments:
   :func:`spmm_static` over a :class:`SpmmGeom` (square, what
   ``SpmmOperator.bind_external`` returns), and :func:`spmm_bi_static`
   over a :class:`BiSpmmGeom` (rectangular: ``n_src`` input rows,
   ``n_dst`` output rows; built by :func:`pack_bipartite_tables`). The
   geometry holds the forward CSR (``n_dst`` x ``n_src``), its transpose
   and the sizes; the JAX package's windows and tiles have no
   counterpart. Both are differentiable in x only.
   :class:`StaticBiSpmm` is the rectangular form in buffers of a
   loader's budget, loaded batch after batch, which a captured step
   reads.
4. :func:`spmm_csr` — the wrapper of the hand-written CUDA kernel
   ``csrc/spmm_csr.cu``, which replaces the Pallas kernel
   ``ops/spmm.py:_spmm_kernel`` of the JAX package. What bounds it is
   bytes; its source says how its design meets that. Beside it:
   :func:`spmm_csr_plain`, the same function in plain PyTorch, and
   ``spmm_csr.launches``, a count of kernel launches.

The wrapper takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel, and raises if the build or the launch
fails: there is no fallback.
"""

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from pytorch_geometric_tpu_torch.debug import is_debug_enabled
from pytorch_geometric_tpu_torch.ops.csr import (
    Csr, StaticCsr, build_csr, copy_into, host_array, real_entries)
from pytorch_geometric_tpu_torch.ops.segment import scatter


def _check_edges(senders, receivers, x, num_nodes, weights):
    """Debug-mode validation of :func:`spmm`'s inputs, on the host before
    anything is gathered (the JAX package's message passing does the same
    under its flag). Without it a negative sender gathers from the end of
    ``x`` and an index past it fails inside the gather."""
    s, r = host_array(senders), host_array(receivers)
    if s.shape != r.shape or s.ndim != 1:
        raise ValueError("senders/receivers shape mismatch: "
                         f"{s.shape} vs {r.shape}")
    if s.size and (s.min() < 0 or s.max() >= x.shape[0]):
        raise ValueError(f"sender indices out of range [0, {x.shape[0]})")
    if r.size and (r.min() < 0 or r.max() >= num_nodes):
        raise ValueError(f"receiver indices out of range [0, {num_nodes})")
    if weights is not None and tuple(weights.shape[:1]) != s.shape:
        raise ValueError(f"weights has {tuple(weights.shape)[:1]} rows, "
                         f"expected {s.shape}")


def spmm(senders, receivers, x, num_nodes, weights=None, reduce="sum",
         indices_are_sorted=False):
    """out[r] = reduce_{e: receivers[e]==r} weights[e] * x[senders[e]].

    Plain path: per-edge gather then segment reduce. ``num_nodes`` is the
    output row count (padded node count of the graph bucket). Under
    ``debug.debug()`` the edge indices are validated first."""
    if is_debug_enabled():
        _check_edges(senders, receivers, x, num_nodes, weights)
    msg = x[senders.long()]
    if weights is not None:
        msg = msg * weights.reshape(
            weights.shape + (1,) * (msg.ndim - weights.ndim))
    return scatter(msg, receivers, num_nodes, reduce=reduce)


# ---------------------------------------------------------------------------
# CSR SpMM: the CUDA kernel's wrapper and its plain version
# ---------------------------------------------------------------------------

def spmm_csr_plain(csr: Csr, val, x):
    """``out[r] = sum_{p in row r} val[p] * x[col[p]]`` in fp32, in plain
    PyTorch: the kernel's reference. It sums the first
    :func:`real_entries` positions (a static CSR's spare slots are never
    read)."""
    nnz = real_entries(csr)
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=x.device), counts,
        output_size=nnz)    # known size: no device sync
    msg = x[csr.col[:nnz].long()].float() * val[:nnz, None]
    out = torch.zeros((csr.num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, rows, msg)


def _check(csr: Csr, val, x):
    if x.ndim != 2 or x.shape[0] != csr.num_cols:
        raise ValueError(f"x must be ({csr.num_cols}, F), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if val.dtype != torch.float32 or val.shape != (csr.num_edges,):
        raise ValueError(f"val must be float32 ({csr.num_edges},), got "
                         f"{val.dtype} {tuple(val.shape)}")
    for name, t in (("row_ptr", csr.row_ptr), ("col", csr.col)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32")
    devices = {t.device for t in (csr.row_ptr, csr.col, val, x)}
    if len(devices) != 1:
        raise ValueError(f"csr, val and x must share one device, got "
                         f"{sorted(map(str, devices))}")


def spmm_csr(csr: Csr, val, x):
    """Weighted CSR SpMM, fp32 out: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor. ``val`` is in CSR position order. One
    group of lanes sums each row, so a call takes as long as its longest
    row: leave zero-weight edges out of the CSR (as the GCN path does)."""
    _check(csr, val, x)
    if x.device.type == "cpu":
        return spmm_csr_plain(csr, val, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr runs on cpu or cuda, not {x.device}")
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("spmm_csr")
    x = x.contiguous()
    val = val.contiguous()
    out = torch.empty((csr.num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.spmm_csr(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), val.data_ptr(),
            x.data_ptr(), out.data_ptr(), csr.num_rows, x.shape[1],
            int(x.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed: CUDA error {rc}")
    spmm_csr.launches += 1
    return out


#: Launches of the CUDA kernel; the CPU path never adds to it.
spmm_csr.launches = 0


# ---------------------------------------------------------------------------
# SpmmOperator
# ---------------------------------------------------------------------------

class SpmmOperator:
    """SpMM bound to a fixed edge structure.

    Built on the host once per graph: a receiver-major CSR (``fwd``) and
    its transpose (``bwd``), both moved to ``device``. Differentiable in
    (weights, x): ``dx`` runs the transposed CSR through the same kernel;
    ``dweights`` is the SDDMM ``sum_f g[recv] * x[send]`` in plain
    PyTorch, as the JAX package leaves it to XLA.

    ``compute_dtype=torch.bfloat16`` hands x to the kernel in bf16
    (products and sums stay fp32); the output is always fp32.

    ``edge_mask`` (E,) builds both CSRs over the edges it marks only: the
    weights stay (E,) in edge order, and an edge left out must have
    weight 0 (a collated batch's padding edges, ``graph.edge_mask``).
    Every row's sum is then bitwise the full operator's, and the padding
    node's row holds no entry for one group of lanes to walk.

    Usage::

        op = SpmmOperator(senders, receivers, num_nodes, device="cuda")
        out = op(weights, x)          # (num_nodes, F)
    """

    def __init__(self, senders, receivers, num_nodes, *,
                 compute_dtype=torch.float32, edge_mask=None,
                 device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        _compute_name(compute_dtype)
        s = host_array(senders)
        r = host_array(receivers)
        edges = None if edge_mask is None else \
            np.flatnonzero(host_array(edge_mask))
        self.num_nodes = int(num_nodes)
        self.compute_dtype = compute_dtype
        self.fwd = build_csr(r, s, self.num_nodes, edges=edges).to(dev)
        self.bwd = build_csr(s, r, self.num_nodes, edges=edges).to(dev)
        self.senders = torch.from_numpy(s.astype(np.int64)).to(dev)
        self.receivers = torch.from_numpy(r.astype(np.int64)).to(dev)

    def _run(self, csr: Csr, val, x):
        return spmm_csr(csr, val, x.to(self.compute_dtype))

    def to(self, device):
        """This operator, its CSRs and edge lists moved to ``device``: an
        operator built on the host (``device="cpu"``) uploaded once."""
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        for name in ("fwd", "bwd", "senders", "receivers"):
            value = getattr(self, name)
            if value is not None:
                setattr(self, name, value.to(dev))
        return self

    def route_weights(self, weights):
        """Static per-edge ``weights`` (a tensor, array or sequence, in edge
        order) as fp32 values in the order of each CSR: ``(val_f, val_b)``
        on the operator's device (the role of the JAX
        ``pack_weights_host``)."""
        if isinstance(weights, torch.Tensor):
            w = weights.detach()
        else:
            w = torch.from_numpy(np.asarray(weights, dtype=np.float32))
        w = w.to(device=self.fwd.perm.device, dtype=torch.float32)
        return (w[self.fwd.perm].contiguous(),
                w[self.bwd.perm].contiguous())

    def bind(self, weights):
        """Closure with *static* weights routed into both CSR orders once:
        no per-edge gather on the training hot path. Differentiable in x
        only (no gradient w.r.t. the bound weights; use ``__call__`` for
        that)."""
        val_f, val_b = self.route_weights(weights)

        def f(x):
            return _BoundSpmm.apply(x, self, val_f, val_b)

        return f

    def bind_external(self, weights):
        """Static-weight SpMM with the routed weights as an explicit
        argument, as the JAX ``bind_external``: returns ``(fn, consts)``
        where ``consts`` holds both CSRs' values and ``fn(consts, x)`` is
        :func:`spmm_static` over this operator's geometry; it equals
        ``bind(weights)(x)`` and is differentiable in x."""
        val_f, val_b = self.route_weights(weights)
        geom = SpmmGeom.make(self.fwd, self.bwd, self.num_nodes,
                             _compute_name(self.compute_dtype))
        return functools.partial(spmm_static, geom), {"fwd": val_f,
                                                      "bwd": val_b}

    def __call__(self, weights, x):
        return _SpmmApply.apply(weights, x, self)


class StaticSpmmOperator(SpmmOperator):
    """A :class:`SpmmOperator` in static buffers: both CSRs with
    ``num_edges`` entry slots (:class:`~.csr.StaticCsr`) and the (E,)
    edge lists, on ``device``, loaded in place from an operator of each
    batch (:meth:`load`). A captured step reads these buffers, so one
    CUDA graph serves every batch of a loader's budget; the calls are
    :class:`SpmmOperator`'s."""

    def __init__(self, num_nodes: int, num_edges: int, *,
                 compute_dtype=torch.float32, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        _compute_name(compute_dtype)
        self.num_nodes = int(num_nodes)
        self.compute_dtype = compute_dtype
        self.fwd, self.bwd = (StaticCsr.empty(self.num_nodes, self.num_nodes,
                                              num_edges, dev)
                              for _ in range(2))
        self.senders, self.receivers = (
            torch.zeros(num_edges, dtype=torch.int64, device=dev)
            for _ in range(2))

    def load(self, op: SpmmOperator) -> "StaticSpmmOperator":
        """Copy ``op`` (a batch's operator, on the host or the card) in on
        the current stream, without a host wait."""
        if op.num_nodes != self.num_nodes or \
                op.compute_dtype != self.compute_dtype or \
                op.senders.shape != self.senders.shape:
            raise ValueError(f"an operator of {op.num_nodes} nodes and "
                             f"{op.senders.shape[0]} edges "
                             f"({op.compute_dtype}) does not fit static "
                             f"buffers of {self.num_nodes} and "
                             f"{self.senders.shape[0]} "
                             f"({self.compute_dtype})")
        self.fwd.load(op.fwd)
        self.bwd.load(op.bwd)
        copy_into(self.senders, op.senders)
        copy_into(self.receivers, op.receivers)
        return self


class _BoundSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, val_f, val_b):
        ctx.op, ctx.val_b, ctx.x_dtype = op, val_b, x.dtype
        return op._run(op.fwd, val_f, x)

    @staticmethod
    def backward(ctx, g):
        if ctx.op.bwd is None:
            raise RuntimeError("this operator was built for the forward "
                               "direction only: no gradient in x")
        dx = ctx.op._run(ctx.op.bwd, ctx.val_b, g.float())
        return dx.to(ctx.x_dtype), None, None, None


class _SpmmApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, x, op):
        ctx.op = op
        ctx.save_for_backward(weights, x)
        return op._run(op.fwd, weights.float()[op.fwd.perm], x)

    @staticmethod
    def backward(ctx, g):
        weights, x = ctx.saved_tensors
        op = ctx.op
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = op._run(op.bwd, weights.float()[op.bwd.perm],
                         g.float()).to(x.dtype)
        if ctx.needs_input_grad[0]:
            dw = (g[op.receivers] * x[op.senders].float()).sum(-1)
            dw = dw.to(weights.dtype)
        return dw, dx, None


# ---------------------------------------------------------------------------
# The static forms: explicit-argument and rectangular SpMM
# ---------------------------------------------------------------------------

_COMPUTE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _compute_name(dtype) -> str:
    for name, dt in _COMPUTE.items():
        if dt == dtype:
            return name
    raise TypeError(f"compute_dtype must be float32 or bfloat16, got {dtype}")


@dataclasses.dataclass(frozen=True, eq=False)
class BiSpmmGeom:
    """Static geometry of :func:`spmm_bi_static`: ``fwd``, the CSR of
    ``n_dst`` rows over ``n_src`` columns; ``bwd``, its transpose (None
    for a forward-only operator); ``compute``, ``"f32"`` or ``"bf16"``
    (x handed to the kernel in bf16, products and sums in fp32)."""

    fwd: Csr
    bwd: Optional[Csr]
    n_src: int
    n_dst: int
    compute: str = "bf16"

    @staticmethod
    def make(fwd: Csr, bwd: Optional[Csr], n_src_nodes: int,
             n_dst_nodes: int, compute: str = "bf16") -> "BiSpmmGeom":
        return BiSpmmGeom(fwd, bwd, int(n_src_nodes), int(n_dst_nodes),
                          compute)

    def __post_init__(self):
        if self.compute not in _COMPUTE:
            raise ValueError(f"compute must be one of {sorted(_COMPUTE)}, "
                             f"got {self.compute!r}")
        if (self.fwd.num_rows, self.fwd.num_cols) != (self.n_dst,
                                                      self.n_src):
            raise ValueError(f"fwd CSR is {self.fwd.num_rows} x "
                             f"{self.fwd.num_cols}, expected {self.n_dst} x "
                             f"{self.n_src}")
        if self.bwd is not None and (self.bwd.num_rows, self.bwd.num_cols) \
                != (self.n_src, self.n_dst):
            raise ValueError("bwd CSR must be the transpose of fwd")

    def _run(self, csr: Csr, val, x):
        return spmm_csr(csr, val, x.to(_COMPUTE[self.compute]))


@dataclasses.dataclass(frozen=True, eq=False)
class SpmmGeom(BiSpmmGeom):
    """Static geometry of :func:`spmm_static`: a square
    :class:`BiSpmmGeom` of ``num_nodes`` rows (what
    ``SpmmOperator.bind_external`` returns)."""

    @property
    def num_nodes(self) -> int:
        return self.n_src

    @staticmethod
    def make(fwd: Csr, bwd: Optional[Csr], num_nodes: int,
             compute: str = "f32") -> "SpmmGeom":
        return SpmmGeom(fwd, bwd, int(num_nodes), int(num_nodes), compute)


def spmm_static(geom: SpmmGeom, consts, x):
    """``out = A x`` with static weights: ``consts`` holds each CSR's
    values (``{"fwd": ..., "bwd": ...}``, from
    ``SpmmOperator.bind_external``). One ``spmm_csr`` a direction;
    differentiable in x (the backward runs the transposed CSR)."""
    return _BoundSpmm.apply(x, geom, consts["fwd"], consts.get("bwd"))


def spmm_bi_static(geom: BiSpmmGeom, consts, x):
    """``out (n_dst, F) = A x (n_src, F)`` with static weights (from
    :func:`pack_bipartite_tables`); differentiable in x, with ``dx`` in
    x's dtype."""
    return _BoundSpmm.apply(x, geom, consts["fwd"], consts.get("bwd"))


def pack_bipartite_tables(senders, receivers, n_src, n_dst, weights, *,
                          compute_dtype=torch.bfloat16,
                          directions=("fwd", "bwd"), device="cuda"):
    """``(geom, consts)`` of :func:`spmm_bi_static` for the edges
    ``senders[e]`` (< ``n_src``) -> ``receivers[e]`` (< ``n_dst``) with
    static ``weights``, built on the host and moved to ``device``:
    ``consts["fwd"]`` maps the src rows to the dst rows and
    ``consts["bwd"]`` the transpose, the weights routed into each CSR's
    order. ``directions=("fwd",)`` builds the forward only."""
    from pytorch_geometric_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    s, r = host_array(senders), host_array(receivers)
    w = torch.from_numpy(np.asarray(host_array(weights), dtype=np.float32))
    csrs, consts = {}, {}
    for which, (rows, cols, nr, nc) in (("fwd", (r, s, n_dst, n_src)),
                                        ("bwd", (s, r, n_src, n_dst))):
        if which in directions:
            csr = build_csr(rows, cols, int(nr), int(nc))
            csrs[which] = csr.to(dev)
            consts[which] = w[csr.perm].contiguous().to(dev)
    geom = BiSpmmGeom.make(csrs["fwd"], csrs.get("bwd"), n_src, n_dst,
                           _compute_name(compute_dtype))
    return geom, consts


class StaticBiSpmm:
    """:func:`spmm_bi_static` over static buffers on ``device``: the
    forward CSR (``n_dst`` x ``n_src``) and its transpose, each of
    ``capacity`` entry slots (:class:`~.csr.StaticCsr`), and both CSRs'
    values, loaded in place from each batch's operator (:meth:`load`).
    A captured step reads these buffers, so one CUDA graph serves every
    batch of a loader's budget. A batch's entries end at each CSR's
    ``row_ptr`` end, where the kernel stops: the spare slots (and their
    values) are never read. Differentiable in x, as
    :func:`spmm_bi_static`."""

    def __init__(self, n_src: int, n_dst: int, capacity: int, *,
                 compute_dtype=torch.float32, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.geom = BiSpmmGeom.make(
            StaticCsr.empty(n_dst, n_src, capacity, dev),
            StaticCsr.empty(n_src, n_dst, capacity, dev), n_src, n_dst,
            _compute_name(compute_dtype))
        self.consts = {d: torch.zeros(capacity, dtype=torch.float32,
                                      device=dev) for d in ("fwd", "bwd")}

    def load(self, op) -> "StaticBiSpmm":
        """Copy a batch's operator in on the current stream, without a
        host wait: ``(geom, consts)`` of :func:`pack_bipartite_tables`
        (both directions), or a ``functools.partial`` of
        :func:`spmm_bi_static` over them (what
        ``nn/conv/spline_conv.py:spline_operator`` returns)."""
        geom, consts = op.args if isinstance(op, functools.partial) else op
        if geom.bwd is None or geom.compute != self.geom.compute:
            raise ValueError(f"an operator of compute {geom.compute!r} "
                             f"with{'out' if geom.bwd is None else ''} its "
                             f"transpose does not fit static buffers of "
                             f"{self.geom.compute!r} with it")
        self.geom.fwd.load(geom.fwd)
        self.geom.bwd.load(geom.bwd)
        for d in ("fwd", "bwd"):
            copy_into(self.consts[d], consts[d])
        return self

    def __call__(self, x):
        return spmm_bi_static(self.geom, self.consts, x)
