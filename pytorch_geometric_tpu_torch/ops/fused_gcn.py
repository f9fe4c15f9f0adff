"""Fused two-layer GCN: both aggregations and the elementwise work between
them in two launches per direction.

Counterpart of ``pytorch_geometric_tpu/ops/fused_gcn.py``:

    out = A (drop(relu(A z1 + b1)) @ W2)

with ``A`` the static normalised adjacency. The caller computes
``z1 = x @ W1`` before and adds ``b2`` after.

1. :func:`keep_mask` — the dropout mask, (N, H) bool: the stateless hash
   of (feature, node, seed) of the JAX ``_host_keep_mask``, bit for bit.
2. :func:`fused_gcn_fwd` / :func:`fused_gcn_bwd` — wrappers of the
   hand-written CUDA kernels of ``csrc/fused_gcn.cu``, which replace the
   Pallas kernel ``ops/fused_gcn.py:_fused_kernel``: both aggregations on
   ``row_lanes.cuh``'s row map (4 lanes a row, its edges loaded
   together), the per-node step (bias, relu, dropout and the W2 product)
   in the first walk's rows, and the second walk as a second launch that
   Hopper's programmatic dependent launch starts early; it reads a
   scratch the wrapper allocates with rows padded to a multiple of 4
   floats. Beside them the plain versions :func:`fused_gcn_fwd_plain` /
   :func:`fused_gcn_bwd_plain` and the ``.launches`` counts (two a
   call).
3. :class:`FusedGcn2` — the operator with the JAX call contract,
   differentiable in (z1, W2, b1).

The wrappers take the plain versions only for tensors on the CPU. For
CUDA tensors they launch the kernels, and raise if the build or the launch
fails: there is no fallback.
"""

import ctypes

import torch

from pytorch_geometric_tpu_torch.ops.csr import Csr
from pytorch_geometric_tpu_torch.ops.packed_gat import seed_tensor
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm_csr_plain

#: Widest hidden and class dimensions the kernels take (the JAX op's W2
#: block is (16, 128): hidden and classes up to 16 in practice).
MAX_WIDTH = 16

_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of the keep test ``hash < threshold``."""
    return int((1.0 - rate) * (2 ** 32 - 1))


def keep_mask(seed, H: int, N: int, rate: float):
    """(N, H) bool keep mask of dropout ``rate``: the hash of (feature f,
    node c, seed) of the JAX ``_host_keep_mask``, in int64 arithmetic
    masked to 32 bits after each product. ``seed`` is an int or a tensor
    (any dtype, cast to int32 as the JAX op does); a tensor seed stays on
    its device (no wait on the card)."""
    m = _MASK32
    if isinstance(seed, torch.Tensor):
        device = seed.device
        s = seed.reshape(()).to(torch.int32).to(torch.int64) & m
    else:
        device = torch.device("cpu")
        s = int(seed) & m
    f = torch.arange(H, dtype=torch.int64, device=device)[None, :]
    c = torch.arange(N, dtype=torch.int64, device=device)[:, None]
    h = (((f * 0x9E3779B1) & m) + ((c * 0x85EBCA77) & m) + s) & m
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & m
    h = ((h ^ (h >> 12)) * 0x297A2D39) & m
    h = h ^ (h >> 15)
    return h < keep_threshold(rate)


def _keep(seed, n: int, H: int, rate: float):
    """The keep mask of ``rate``, or None when nothing is dropped."""
    return keep_mask(seed, H, n, rate) if rate > 0.0 else None


def _dropped(h1_pre, b1, keep, rate):
    """drop(relu(h1_pre + b1)): the hidden layer as the second
    aggregation sees it (``keep`` None: no dropout)."""
    h = torch.relu(h1_pre + b1)
    if keep is not None:
        h = torch.where(keep.to(h.device), h / (1.0 - rate), 0.0)
    return h


def _hidden_grad(gA2, W2, b1, h1_pre, keep, rate):
    """dh1 = (gA2 @ W2^T) * keep / (1 - rate) * [h1_pre + b1 > 0]."""
    dh1d = gA2 @ W2.t()
    act = h1_pre + b1 > 0.0
    if keep is not None:
        act = act & keep.to(act.device)
        dh1d = dh1d / (1.0 - rate)
    return torch.where(act, dh1d, 0.0)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers and their plain versions
# ---------------------------------------------------------------------------

def fused_gcn_fwd_plain(fwd: Csr, val, z1, W2, b1, seed, rate: float):
    """``(h1_pre, out)`` with ``h1_pre = A z1`` and
    ``out = A (drop(relu(h1_pre + b1)) @ W2)``, fp32, in plain PyTorch
    over the receiver-major CSR: the forward kernel's reference."""
    h1_pre = spmm_csr_plain(fwd, val, z1)
    keep = _keep(seed, *h1_pre.shape, rate)
    out = spmm_csr_plain(fwd, val, _dropped(h1_pre, b1, keep, rate) @ W2)
    return h1_pre, out


def fused_gcn_bwd_plain(bwd: Csr, val, g2, W2, b1, h1_pre, seed,
                        rate: float):
    """``(gA2, dz1)`` with ``gA2 = A^T g2``,
    ``dh1 = (gA2 @ W2^T) * keep / (1 - rate) * [h1_pre + b1 > 0]`` and
    ``dz1 = A^T dh1``, fp32, in plain PyTorch over the transposed CSR:
    the backward kernel's reference (the JAX kernel's mirrored phases)."""
    gA2 = spmm_csr_plain(bwd, val, g2)
    keep = _keep(seed, *h1_pre.shape, rate)
    dz1 = spmm_csr_plain(bwd, val,
                         _hidden_grad(gA2, W2, b1, h1_pre, keep, rate))
    return gA2, dz1


def _check(csr: Csr, val, x, W2, b1, seed, rate, h1_pre=None,
           backward=False):
    if W2.ndim != 2 or not all(1 <= d <= MAX_WIDTH for d in W2.shape):
        raise ValueError(f"W2 must be (H, C) with H and C in [1, "
                         f"{MAX_WIDTH}], got {tuple(W2.shape)}")
    H, C = W2.shape
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if csr.num_rows != csr.num_cols:
        raise ValueError("the CSR must be square (N x N)")
    n, width = csr.num_rows, (C if backward else H)
    for name, t, shape in (("input", x, (n, width)), ("b1", b1, (H,)),
                           ("val", val, (csr.num_edges,)),
                           ("h1_pre", h1_pre, (n, H))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    floats = [t for t in (val, x, W2, b1, h1_pre) if t is not None]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("val, the input, W2, b1 and h1_pre must be float32")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise TypeError("seed must be a one-element int32 tensor")
    devices = {t.device for t in floats + [seed, csr.row_ptr, csr.col]}
    if len(devices) != 1:
        raise ValueError(f"every input must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused GCN kernels run on cpu or cuda, not "
                         f"{device}")
    return device


def _padded(width: int) -> int:
    """Floats a row of the kernels' scratch (z2, dh1): ``width`` rounded
    up to a multiple of 4, so that each row is one or more float4s."""
    return (width + 3) // 4 * 4


def _launch(name, csr: Csr, val, x, W2, b1, seed, h1_pre, outputs, rate):
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("fused_gcn")
    H, C = W2.shape
    args = [t.contiguous() for t in (val, x, W2, b1)]
    tail = [h1_pre.contiguous()] if h1_pre is not None else []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, name)(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(),
            *(t.data_ptr() for t in args), seed.data_ptr(),
            *(t.data_ptr() for t in tail), *(t.data_ptr() for t in outputs),
            csr.num_rows, H, C, keep_threshold(rate), float(1.0 - rate),
            int(rate > 0.0), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def fused_gcn_fwd(fwd: Csr, val, z1, W2, b1, seed, rate: float):
    """``(h1_pre, out)`` of :func:`fused_gcn_fwd_plain`: two launches of
    the CUDA kernels on CUDA tensors, the plain version on CPU tensors.
    ``val`` is in CSR position order, ``seed`` a one-element int32 tensor
    read on the device."""
    device = _check(fwd, val, z1, W2, b1, seed, rate)
    if device.type == "cpu":
        return fused_gcn_fwd_plain(fwd, val, z1, W2, b1, seed, rate)
    n, (H, C) = fwd.num_rows, W2.shape
    h1_pre, z2, out = (torch.empty((n, w), dtype=torch.float32,
                                   device=device)
                       for w in (H, _padded(C), C))
    _launch("fused_gcn_fwd", fwd, val, z1, W2, b1, seed, None,
            (h1_pre, z2, out), rate)
    fused_gcn_fwd.launches += 2
    return h1_pre, out


def fused_gcn_bwd(bwd: Csr, val, g2, W2, b1, h1_pre, seed, rate: float):
    """``(gA2, dz1)`` of :func:`fused_gcn_bwd_plain`: two launches of the
    CUDA kernels on CUDA tensors, the plain version on CPU tensors."""
    device = _check(bwd, val, g2, W2, b1, seed, rate, h1_pre, backward=True)
    if device.type == "cpu":
        return fused_gcn_bwd_plain(bwd, val, g2, W2, b1, h1_pre, seed, rate)
    n, (H, C) = bwd.num_rows, W2.shape
    gA2, dh1, dz1 = (torch.empty((n, w), dtype=torch.float32,
                                 device=device)
                     for w in (C, _padded(H), H))
    _launch("fused_gcn_bwd", bwd, val, g2, W2, b1, seed, h1_pre,
            (gA2, dh1, dz1), rate)
    fused_gcn_bwd.launches += 2
    return gA2, dz1


#: Launches of the CUDA kernels; the CPU path never adds to them.
fused_gcn_fwd.launches = 0
fused_gcn_bwd.launches = 0


# ---------------------------------------------------------------------------
# FusedGcn2
# ---------------------------------------------------------------------------

class FusedGcn2:
    """``out = A (drop(relu(A z1 + b1)) @ W2)`` in two launches per
    direction, differentiable in (z1, W2, b1); the caller adds ``b2``.

    ``A`` is the edge set ``senders -> receivers`` with static
    ``weights``; ``op`` is its :class:`SpmmOperator` (fp32), used for the
    evaluation (``op.bind_external``). Call as ``op(z1, W2, b1, seed)``
    with z1 (N, hidden), W2 (hidden, classes), b1 (hidden,).

    Limits: ``hidden`` and ``classes`` at most 16 (:data:`MAX_WIDTH`;
    the JAX op's W2 block is (16, 128)); ``ValueError`` beyond.

    The dropout seed is an int or an int32 tensor of one element that the
    kernels read from device memory (no wait on the card); a float tensor
    is cast to int32, as the JAX op casts its float32 seed. The keep mask
    of node c and feature f is :func:`keep_mask`'s, whatever the device.
    """

    def __init__(self, senders, receivers, num_nodes, weights, *,
                 hidden: int, classes: int, dropout_rate: float = 0.5,
                 device="cuda"):
        if not (1 <= hidden <= MAX_WIDTH and 1 <= classes <= MAX_WIDTH):
            raise ValueError(f"hidden and classes must be in [1, "
                             f"{MAX_WIDTH}], got {hidden} and {classes}")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        self.op = SpmmOperator(senders, receivers, num_nodes, device=device)
        self.N = int(num_nodes)
        self.hidden, self.classes = int(hidden), int(classes)
        self.rate = float(dropout_rate)
        self.val_f, self.val_b = self.op.route_weights(weights)
        self._seeds = {}

    def __call__(self, z1, W2, b1, seed):
        seed = seed_tensor(self._seeds, seed, self.val_f.device)
        return _FusedApply.apply(z1, W2, b1, self, seed)


class _FusedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, W2, b1, op, seed):
        z1f, W2f, b1f = z1.float(), W2.float(), b1.float()
        h1_pre, out = fused_gcn_fwd(op.op.fwd, op.val_f, z1f, W2f, b1f, seed,
                                    op.rate)
        ctx.op, ctx.dtypes = op, (z1.dtype, W2.dtype, b1.dtype)
        ctx.save_for_backward(W2f, b1f, h1_pre, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        W2, b1, h1_pre, seed = ctx.saved_tensors
        op = ctx.op
        gA2, dz1 = fused_gcn_bwd(op.op.bwd, op.val_b, g.float().contiguous(),
                                 W2, b1, h1_pre, seed, op.rate)
        # dW2 and db1 in plain PyTorch, as the JAX VJP leaves them to XLA
        keep = _keep(seed, *h1_pre.shape, op.rate)
        dW2 = _dropped(h1_pre, b1, keep, op.rate).t() @ gA2
        db1 = _hidden_grad(gA2, W2, b1, h1_pre, keep, op.rate).sum(0)
        dz1_t, dW2_t, db1_t = ctx.dtypes
        return dz1.to(dz1_t), dW2.to(dW2_t), db1.to(db1_t), None, None
