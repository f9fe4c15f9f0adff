"""SpMM — the hot op under every weighted aggregation.

Counterpart of ``pytorch_geometric_tpu/ops/spmm.py``:

1. ``spmm`` — the plain path: per-edge gather, weight, ``index_add_``.
2. ``SpmmOperator`` — bound to a fixed edge structure, built once per
   graph on the host. ``op(weights, x)`` is differentiable in weights and
   x; ``op.bind(weights)`` fixes static weights (GCN's normalised
   adjacency) and is differentiable in x. Forward and ``dx`` both run
   :func:`spmm_csr`, over the receiver-major CSR and over its transpose.
3. :func:`spmm_csr` — the wrapper of the hand-written CUDA kernel
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

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import Csr, build_csr
from pytorch_geometric_tpu_torch.ops.segment import scatter


def spmm(senders, receivers, x, num_nodes, weights=None, reduce="sum",
         indices_are_sorted=False):
    """out[r] = reduce_{e: receivers[e]==r} weights[e] * x[senders[e]].

    Plain path: per-edge gather then segment reduce. ``num_nodes`` is the
    output row count (padded node count of the graph bucket)."""
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
    PyTorch: the kernel's reference."""
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=x.device), counts,
        output_size=csr.num_edges)    # known size: no device sync
    msg = x[csr.col.long()].float() * val[:, None]
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

    Usage::

        op = SpmmOperator(senders, receivers, num_nodes, device="cuda")
        out = op(weights, x)          # (num_nodes, F)
    """

    def __init__(self, senders, receivers, num_nodes, *,
                 compute_dtype=torch.float32, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"compute_dtype must be float32 or bfloat16, "
                            f"got {compute_dtype}")
        s = _host(senders)
        r = _host(receivers)
        self.num_nodes = int(num_nodes)
        self.compute_dtype = compute_dtype
        self.fwd = build_csr(r, s, self.num_nodes).to(dev)
        self.bwd = build_csr(s, r, self.num_nodes).to(dev)
        self.senders = torch.from_numpy(s.astype(np.int64)).to(dev)
        self.receivers = torch.from_numpy(r.astype(np.int64)).to(dev)

    def _run(self, csr: Csr, val, x):
        return spmm_csr(csr, val, x.to(self.compute_dtype))

    def bind(self, weights):
        """Closure with *static* weights routed into both CSR orders once:
        no per-edge gather on the training hot path. Differentiable in x
        only (no gradient w.r.t. the bound weights; use ``__call__`` for
        that)."""
        w = weights.detach().float()
        val_f = w[self.fwd.perm].contiguous()
        val_b = w[self.bwd.perm].contiguous()

        def f(x):
            return _BoundSpmm.apply(x, self, val_f, val_b)

        return f

    def __call__(self, weights, x):
        return _SpmmApply.apply(weights, x, self)


class _BoundSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, val_f, val_b):
        ctx.op, ctx.val_b, ctx.x_dtype = op, val_b, x.dtype
        return op._run(op.fwd, val_f, x)

    @staticmethod
    def backward(ctx, g):
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


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)
