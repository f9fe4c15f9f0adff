"""Fused GAT layer: attention, softmax and aggregation in one kernel.

Counterpart of ``pytorch_geometric_tpu/ops/packed_gat.py``
(``PackedFlashGat``), with the same call contract and numerics:

- per head, logits ``z = leaky(s[src] + d[dst])``; a per-receiver
  softmax shift ``leaky(m + d[dst])`` with ``m = max(s)`` over all rows
  (no segment-max pass; the shift carries no gradient);
- attention dropout regenerated from :func:`edge_keep_bits`, a stateless
  hash of (seed, original edge id, head), so the forward and both
  backward passes agree whatever order they walk the edges in;
- the raw ``(N, H*C + H)`` num‖den accumulator (the numerator takes the
  dropped weights, the denominator the undropped ones); the division
  happens outside the kernel, in plain PyTorch.

The JAX package packs edges into (sender window, receiver window) tiles
for the TPU's one-hot matrix products. Here the host builds two CSRs of
one edge list: receiver-major (forward, and ``dd``) and sender-major
(``ds`` and ``dh``). As in the JAX package, the edge list comes from a
dense mask (``adj_bool``, taken in ``np.nonzero`` order) or as
``senders`` / ``receivers``, duplicate pairs included (each is a softmax
slot of its own, as on the sparse path). Its receivers must not
decrease (``gat_edge_set`` and ``gat_sparse_edge_set`` of
``nn/conv/gat_conv.py`` give such lists): the CSR is a stable sort by
receiver, so a receiver-major CSR position is then the edge's input
index, which dropout hashes as the JAX operator does, and the
sender-major CSR's ``perm`` gives it back. A list whose receivers
decrease is refused; the kernels take no table of edge ids on the
receiver side.

:func:`packed_gat_fwd` and :func:`packed_gat_bwd` wrap the hand-written
CUDA kernels of ``csrc/packed_gat.cu``, which replace the Pallas kernels
``ops/packed_gat.py:_fwd_kernel`` and ``_bwd_kernel``. Beside them:
their plain PyTorch versions and ``.launches``, a count of kernel
launches. A wrapper takes its plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel, or raises.
"""

import ctypes

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import (
    Csr, build_csr, host_array)

_MASK32 = 0xFFFFFFFF


def edge_keep_bits(seed, eid, head):
    """uint32 dropout bits per (edge id, head), as int64 tensors that
    broadcast: the hash of ``ops/packed_gat.py:_edge_keep_bits``, with
    ``& 0xFFFFFFFF`` after each product (every product stays below 2^63
    for ids and seeds below 2^31)."""
    m = _MASK32
    x = ((eid * 0x9E3779B1) & m) ^ ((((seed * 0xC2B2AE3D) & m)
                                     + ((head * 0x27D4EB2F) & m)) & m)
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & m
    x = ((x ^ (x >> 12)) * 0x297A2D39) & m
    return x ^ (x >> 15)


def dropout_threshold(rate: float) -> int:
    """Keep an (edge, head) iff its bits are >= this threshold."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0 else 1.0


def seed_tensor(cache: dict, seed, device):
    """The dropout seed as the one-element int32 tensor on ``device``
    that the kernels read: a tensor is converted in place (no wait on the
    card); an int is copied to the device once per value and kept in
    ``cache``."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(1)
    value = int(seed)
    if value not in cache:
        cache[value] = torch.tensor([value], dtype=torch.int32,
                                    device=device)
    return cache[value]


def _leaky(z, slope):
    return torch.where(z > 0, z, slope * z)


def _edge_terms(csr: Csr, d, s, m, seed, rate, slope):
    """Per-edge (E, H) terms of the receiver-major CSR (edge id = CSR
    position): receiver and sender ids, the pre-activation logit, the
    shifted exp and keep * scale (a tensor, or the float scale where
    nothing is dropped)."""
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=d.device), counts,
        output_size=csr.num_edges)    # known size: no device sync
    recv, send = rows, csr.col.long()
    zpre = s[send] + d[recv]
    ex = torch.exp(_leaky(zpre, slope) - _leaky(m + d[recv], slope))
    thresh, scale = dropout_threshold(rate), dropout_scale(rate)
    if thresh == 0:
        ks = scale
    else:
        heads = torch.arange(d.shape[1], device=d.device)
        eid = torch.arange(csr.num_edges, device=d.device)
        bits = edge_keep_bits(seed.long(), eid[:, None], heads[None])
        ks = torch.where(bits >= thresh, scale, 0.0).float()
    return recv, send, zpre, ex, ks


def packed_gat_fwd_plain(csr: Csr, d, s, h, m, seed, rate: float = 0.0,
                         slope: float = 0.2):
    """The raw ``(N, H*C + H)`` num‖den over the receiver-major ``csr``
    (edge id = CSR position), in plain PyTorch: the kernel's reference."""
    n, H = d.shape
    C = h.shape[1] // H
    recv, send, _, ex, ks = _edge_terms(csr, d, s, m, seed, rate, slope)
    num = h.view(n, H, C)[send] * (ex * ks)[:, :, None]
    msg = torch.cat([num.reshape(-1, H * C), ex], dim=1)
    out = torch.zeros((n, H * C + H), dtype=torch.float32, device=d.device)
    return out.index_add_(0, recv, msg)


def packed_gat_bwd_plain(fwd: Csr, d, s, h, m, seed, g, rate: float = 0.0,
                         slope: float = 0.2):
    """``(dd, ds, dh)`` from ``g``, the gradient of the raw num‖den, in
    plain PyTorch: the kernels' reference. It walks the receiver-major
    CSR alone (edge id = CSR position)."""
    n, H = d.shape
    C = h.shape[1] // H
    recv, send, zpre, ex, ks = _edge_terms(fwd, d, s, m, seed, rate, slope)
    gnum = g[:, :H * C].reshape(n, H, C)[recv]             # (E, H, C)
    gden = g[:, H * C:][recv]                              # (E, H)
    dot = (gnum * h.view(n, H, C)[send]).sum(-1)
    dz = ex * (ks * dot + gden)
    dz = torch.where(zpre > 0, dz, slope * dz)
    zeros = torch.zeros((n, H), dtype=torch.float32, device=d.device)
    dd = zeros.index_add(0, recv, dz)
    ds = zeros.index_add(0, send, dz)
    dh = torch.zeros((n, H * C), dtype=torch.float32, device=d.device)
    dh.index_add_(0, send, (gnum * (ex * ks)[:, :, None]).reshape(-1, H * C))
    return dd, ds, dh


def _check(csrs, d, s, h, m, seed, g=None):
    n, H = d.shape if d.ndim == 2 else (None, None)
    if n is None or s.shape != (n, H) or h.ndim != 2 or h.shape[0] != n \
            or h.shape[1] % H:
        raise ValueError(f"d and s must be (N, H) and h (N, H*C), got "
                         f"{tuple(d.shape)}, {tuple(s.shape)}, "
                         f"{tuple(h.shape)}")
    C = h.shape[1] // H
    if m.shape != (H,):
        raise ValueError(f"m must be ({H},), got {tuple(m.shape)}")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise TypeError(f"seed must be one int32, got {seed.dtype} "
                        f"{tuple(seed.shape)}")
    if g is not None and g.shape != (n, H * C + H):
        raise ValueError(f"g must be ({n}, {H * C + H}), got "
                         f"{tuple(g.shape)}")
    floats = [d, s, h, m] + ([] if g is None else [g])
    for t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("d, s, h, m and g must be contiguous float32")
    for csr in csrs:
        if (csr.num_rows, csr.num_cols) != (n, n):
            raise ValueError(f"the CSR must be ({n}, {n}), got "
                             f"({csr.num_rows}, {csr.num_cols})")
        for t in (csr.row_ptr, csr.col):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise TypeError("row_ptr and col must be contiguous int32")
    devices = {t.device for t in floats + [seed]}
    devices |= {t.device for c in csrs for t in (c.row_ptr, c.col)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed GAT runs on cpu or cuda, not {device}")
    return n, H, C, device


def _launch_args(rate, slope, stream):
    return (ctypes.c_uint(dropout_threshold(rate)),
            ctypes.c_float(dropout_scale(rate)), ctypes.c_float(slope),
            ctypes.c_void_p(stream))


def packed_gat_fwd(csr: Csr, d, s, h, m, seed, rate: float = 0.0,
                   slope: float = 0.2):
    """Raw num‖den ``(N, H*C + H)``: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``csr`` is receiver-major and its
    position is the edge id; ``m`` is ``(H,)``, ``seed`` one int32, both
    read by the kernel from device memory."""
    n, H, C, device = _check([csr], d, s, h, m, seed)
    if device.type == "cpu":
        return packed_gat_fwd_plain(csr, d, s, h, m, seed, rate, slope)
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("packed_gat")
    out = torch.empty((n, H * C + H), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.packed_gat_fwd(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), d.data_ptr(),
            s.data_ptr(), h.data_ptr(), m.data_ptr(), seed.data_ptr(),
            out.data_ptr(), n, H, C, *_launch_args(rate, slope, stream))
    if rc != 0:
        raise RuntimeError(f"packed_gat_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    packed_gat_fwd.launches += 1
    return out


def packed_gat_bwd(fwd: Csr, bwd: Csr, bwd_eid, d, s, h, m, seed, g,
                   rate: float = 0.0, slope: float = 0.2):
    """``(dd, ds, dh)``: on CUDA tensors two launches of the backward
    kernel, over the receiver-major ``fwd`` (``dd``) and the sender-major
    ``bwd`` with its int32 edge ids ``bwd_eid`` (``ds``, ``dh``); on CPU
    tensors the plain version."""
    n, H, C, device = _check([fwd, bwd], d, s, h, m, seed, g)
    if bwd_eid.dtype != torch.int32 or bwd_eid.shape != (bwd.num_edges,) \
            or not bwd_eid.is_contiguous() or bwd_eid.device != device:
        raise TypeError("bwd_eid must be contiguous int32, one per edge of "
                        "bwd, on the inputs' device")
    if device.type == "cpu":
        return packed_gat_bwd_plain(fwd, d, s, h, m, seed, g, rate, slope)
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("packed_gat")
    dd = torch.empty((n, H), dtype=torch.float32, device=device)
    ds = torch.empty((n, H), dtype=torch.float32, device=device)
    dh = torch.empty((n, H * C), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tail = _launch_args(rate, slope, stream)
        for csr, eid, out_h, src_side in ((fwd, None, dd, 0),
                                          (bwd, bwd_eid, ds, 1)):
            rc = lib.packed_gat_bwd(
                csr.row_ptr.data_ptr(), csr.col.data_ptr(),
                None if eid is None else eid.data_ptr(), d.data_ptr(),
                s.data_ptr(), h.data_ptr(), m.data_ptr(), g.data_ptr(),
                seed.data_ptr(), out_h.data_ptr(),
                dh.data_ptr() if src_side else None, n, H, C, *tail[:3],
                src_side, tail[3])
            if rc != 0:
                raise RuntimeError(f"packed_gat_bwd kernel launch failed: "
                                   f"CUDA error {rc}")
            packed_gat_bwd.launches += 1
    return dd, ds, dh


#: Launches of the CUDA kernels; the CPU path never adds to them. The
#: backward counts each of its two launches.
packed_gat_fwd.launches = 0
packed_gat_bwd.launches = 0


class PackedFlashGat:
    """Whole-layer fused GAT over one static edge list.

    Built once per graph on the host: the receiver-major CSR (``fwd``),
    the sender-major CSR (``bwd``) and its edge ids (``bwd_eid``), all on
    ``device``, shared by every layer that uses the op. Same call
    contract as the JAX operator::

        op = PackedFlashGat(adj_bool)                # (N, N) mask, or
        op = PackedFlashGat(senders=s, receivers=r, num_nodes=N)
        out = op(d, s, h2d, seed, rate=0.6)          # (N, H*C) float32
        acc = op(d, s, h2d, seed, raw_out=True)      # (N, H*C + H) num‖den

    ``adj_bool[i, j]`` is the edge j -> i. An edge list may repeat a
    pair; its receivers must not decrease. ``seed`` is an int or a
    one-element integer tensor on the device (the training path draws it
    there, so nothing waits on the card).
    """

    def __init__(self, adj_bool=None, senders=None, receivers=None,
                 num_nodes=None, *, negative_slope: float = 0.2,
                 device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if adj_bool is not None:
            adj = host_array(adj_bool)
            r, s = np.nonzero(adj)     # adj[i, j]: edge j -> i
            num_nodes = adj.shape[0]
        elif senders is None or receivers is None or num_nodes is None:
            raise ValueError("PackedFlashGat takes adj_bool, or senders, "
                             "receivers and num_nodes")
        else:
            s = host_array(senders)
            r = host_array(receivers)
        s, r = s.astype(np.int64), r.astype(np.int64)
        if s.shape != r.shape or (r.size > 1 and (np.diff(r) < 0).any()):
            raise ValueError("the edge list's receivers must not decrease: "
                             "the receiver-major CSR position is the edge "
                             "id that dropout hashes, and it is the input "
                             "index only for such lists")
        n = int(num_nodes)
        self.n, self.E = n, int(s.shape[0])
        self.slope = float(negative_slope)
        self.device = dev
        self.fwd = build_csr(r, s, n).to(dev)       # position = edge id
        self.bwd = build_csr(s, r, n).to(dev)
        self.bwd_eid = self.bwd.perm.to(torch.int32).contiguous()
        self._seeds = {}

    def __call__(self, d, s, h2d, seed, rate: float = 0.0,
                 raw_out: bool = False):
        """``raw_out=True`` returns the undivided ``(N, H*C + H)``
        num‖den, for callers that divide (and add a bias) themselves."""
        acc = _PackedGatRaw.apply(
            d, s, h2d, seed_tensor(self._seeds, seed, d.device), self,
            float(rate))
        if raw_out:
            return acc
        n, H = d.shape
        C = h2d.shape[1] // H
        num, den = acc[:, :H * C], acc[:, H * C:]
        # a node whose best incoming logit sits far below the shift has
        # den (and num) underflowed: its output is ~0, and the gradient
        # must flow through a finite branch
        den = torch.where(den < 1e-16, 1.0, den)
        return (num.reshape(n, H, C) / den[:, :, None]).reshape(n, H * C)


class _PackedGatRaw(torch.autograd.Function):
    """(d, s, h) -> raw num‖den; the backward treats the shift as a
    constant and gives the seed no gradient."""

    @staticmethod
    def forward(ctx, d, s, h, seed, op, rate):
        d, s, h = (t.contiguous() for t in (d, s, h))
        m = s.detach().amax(dim=0).contiguous()
        ctx.save_for_backward(d, s, h, m, seed)
        ctx.op, ctx.rate = op, rate
        return packed_gat_fwd(op.fwd, d, s, h, m, seed, rate, op.slope)

    @staticmethod
    def backward(ctx, g):
        d, s, h, m, seed = ctx.saved_tensors
        op = ctx.op
        dd, ds, dh = packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m,
                                    seed, g.contiguous(), ctx.rate, op.slope)
        return dd, ds, dh, None, None, None
