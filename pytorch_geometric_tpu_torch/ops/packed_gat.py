"""Fused GAT layer: attention, softmax and aggregation in one kernel.

Counterpart of ``pytorch_geometric_tpu/ops/packed_gat.py``
(``PackedFlashGat``), with the same call contract and numerics:

- per head, logits ``z = leaky(s[src] + d[dst])``; a per-receiver
  softmax shift ``leaky(m[dst] + d[dst])``, ``m[dst]`` the largest ``s``
  of ``dst``'s senders (0 for a row without edges), which is the
  receiver's largest logit: the forward kernel finds it in a walk of its
  own over the row and returns it, (N, H), for the backward; the shift
  carries no gradient. The JAX operator shifts by one ``max(s)`` a head
  over all rows, so a receiver whose best logit sits ~87 below it
  underflows there to an output of 0; here no row with an edge does, and
  the normalized output is the segment softmax's (``nn/conv/
  gat_conv.py``'s path without an operator). ``raw_out=True`` rescales
  num‖den to the JAX operator's shift (:func:`global_shift_scale`), so
  the raw values are the JAX ones, underflow included;
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
    Csr, StaticCsr, build_csr, copy_into, host_array, real_entries)

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


def _csr_rows(csr: Csr, device):
    """``(rows, cols)``, int64: the row and column of each of the
    :func:`real_entries` of ``csr`` (a static CSR's spare slots are never
    read)."""
    nnz = real_entries(csr)
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(csr.num_rows, device=device), counts,
        output_size=nnz)    # known size: no device sync
    return rows, csr.col[:nnz].long()


def receiver_max(csr: Csr, s):
    """``m`` (N, H): per row of the receiver-major ``csr`` and head, the
    largest ``s`` of its senders, 0 for a row without edges; no gradient.
    Plain PyTorch (``scatter_reduce``): the forward's shift on the CPU and
    the reference the kernel's ``m`` is held to on the card."""
    s = s.detach()
    rows, cols = _csr_rows(csr, s.device)
    return torch.zeros_like(s).scatter_reduce(
        0, rows[:, None].expand(-1, s.shape[1]), s[cols],
        "amax", include_self=False)


def global_shift_scale(d, s, m, slope: float = 0.2):
    """(N, H) factors that take num‖den from the per-receiver shift to
    the JAX operator's, ``leaky(max(s) + d)`` with one max a head over all
    rows: ``exp(leaky(m + d) - leaky(max(s) + d))``, no gradient. The
    exponent is at most 0 for a row with edges (its ``m`` is at most
    ``max(s)``); a row without edges, whose sums are 0, is clamped there
    too."""
    d, s, m = d.detach(), s.detach(), m.detach()
    shift = _leaky(s.amax(dim=0) + d, slope)
    return torch.exp(torch.clamp(_leaky(m + d, slope) - shift, max=0.0))


def _edge_terms(csr: Csr, d, s, m, seed, rate, slope):
    """Per-edge (E, H) terms of the receiver-major CSR (edge id = CSR
    position): receiver and sender ids, the pre-activation logit, the
    exp shifted by the receiver's ``leaky(m + d)`` and keep * scale (a
    tensor, or the float scale where nothing is dropped)."""
    recv, send = _csr_rows(csr, d.device)
    zpre = s[send] + d[recv]
    ex = torch.exp(_leaky(zpre, slope) - _leaky(m[recv] + d[recv], slope))
    thresh, scale = dropout_threshold(rate), dropout_scale(rate)
    if thresh == 0:
        ks = scale
    else:
        heads = torch.arange(d.shape[1], device=d.device)
        eid = torch.arange(recv.shape[0], device=d.device)
        bits = edge_keep_bits(seed.long(), eid[:, None], heads[None])
        ks = torch.where(bits >= thresh, scale, 0.0).float()
    return recv, send, zpre, ex, ks


def packed_gat_fwd_plain(csr: Csr, d, s, h, m, seed, rate: float = 0.0,
                         slope: float = 0.2):
    """The raw ``(N, H*C + H)`` num‖den over the receiver-major ``csr``
    (edge id = CSR position) at the shift of ``m`` (N, H)
    (:func:`receiver_max`), in plain PyTorch: the kernel's reference."""
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


def _check(csrs, d, s, h, seed, g=None, m=None):
    n, H = d.shape if d.ndim == 2 else (None, None)
    if n is None or s.shape != (n, H) or h.ndim != 2 or h.shape[0] != n \
            or h.shape[1] % H:
        raise ValueError(f"d and s must be (N, H) and h (N, H*C), got "
                         f"{tuple(d.shape)}, {tuple(s.shape)}, "
                         f"{tuple(h.shape)}")
    C = h.shape[1] // H
    if m is not None and m.shape != (n, H):
        raise ValueError(f"m must be ({n}, {H}), one shift a receiver and "
                         f"head, got {tuple(m.shape)}")
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise TypeError(f"seed must be one int32, got {seed.dtype} "
                        f"{tuple(seed.shape)}")
    if g is not None and g.shape != (n, H * C + H):
        raise ValueError(f"g must be ({n}, {H * C + H}), got "
                         f"{tuple(g.shape)}")
    floats = [d, s, h] + [t for t in (m, g) if t is not None]
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


def packed_gat_fwd(csr: Csr, d, s, h, seed, rate: float = 0.0,
                   slope: float = 0.2):
    """``(out, m)``: the raw num‖den ``(N, H*C + H)`` and the shift's
    ``m`` (N, H) (:func:`receiver_max`), the backward's input. The CUDA
    kernel on CUDA tensors (it finds ``m`` in its own walk over each
    row), the plain versions on CPU tensors. ``csr`` is receiver-major and
    its position is the edge id; ``seed`` is one int32 that the kernel
    reads from device memory."""
    n, H, C, device = _check([csr], d, s, h, seed)
    if device.type == "cpu":
        m = receiver_max(csr, s)
        return packed_gat_fwd_plain(csr, d, s, h, m, seed, rate, slope), m
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("packed_gat")
    out = torch.empty((n, H * C + H), dtype=torch.float32, device=device)
    m = torch.empty((n, H), dtype=torch.float32, device=device)
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
    return out, m


def packed_gat_bwd(fwd: Csr, bwd: Csr, bwd_eid, d, s, h, m, seed, g,
                   rate: float = 0.0, slope: float = 0.2):
    """``(dd, ds, dh)``: on CUDA tensors two launches of the backward
    kernel, over the receiver-major ``fwd`` (``dd``) and the sender-major
    ``bwd`` with its int32 edge ids ``bwd_eid`` (``ds``, ``dh``); on CPU
    tensors the plain version. ``m`` is the forward's (N, H)."""
    n, H, C, device = _check([fwd, bwd], d, s, h, seed, g, m)
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
        num‖den, for callers that divide (and add a bias) themselves, at
        the JAX operator's shift (:func:`global_shift_scale`)."""
        acc, m = _PackedGatRaw.apply(
            d, s, h2d, seed_tensor(self._seeds, seed, d.device), self,
            float(rate))
        n, H = d.shape
        C = h2d.shape[1] // H
        if raw_out:
            scale = global_shift_scale(d, s, m, self.slope)
            return torch.cat([(acc[:, :H * C].reshape(n, H, C)
                               * scale[:, :, None]).reshape(n, H * C),
                              acc[:, H * C:] * scale], dim=1)
        num, den = acc[:, :H * C], acc[:, H * C:]
        # a row without edges has den 0 (every other row at least 1): its
        # output is 0, and the gradient must flow through a finite branch
        den = torch.where(den < 1e-16, 1.0, den)
        return (num.reshape(n, H, C) / den[:, :, None]).reshape(n, H * C)


class StaticPackedFlashGat(PackedFlashGat):
    """A :class:`PackedFlashGat` of ``num_nodes`` nodes in static
    buffers on ``device``: both CSRs with ``capacity`` entry slots and
    the sender-major edge ids, loaded in place from the operator of each
    batch (:meth:`load`), which a captured step reads. A batch's edge
    list (``gat_sparse_edge_set``: its real edges and a loop a node) fits
    a capacity of the loader's edge budget plus ``num_nodes``. The CSR
    position stays the edge id that dropout hashes."""

    def __init__(self, num_nodes: int, capacity: int, *,
                 negative_slope: float = 0.2, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.n, self.E = int(num_nodes), int(capacity)
        self.slope = float(negative_slope)
        self.device = dev
        self.fwd, self.bwd = (StaticCsr.empty(self.n, self.n, self.E, dev)
                              for _ in range(2))
        self.bwd_eid = torch.zeros(self.E, dtype=torch.int32, device=dev)
        self._seeds = {}

    def load(self, op: PackedFlashGat) -> "StaticPackedFlashGat":
        """Copy ``op`` (a batch's operator, on the host or the card) in on
        the current stream, without a host wait."""
        if op.n != self.n or op.slope != self.slope:
            raise ValueError(f"an operator of {op.n} nodes (slope "
                             f"{op.slope}) does not fit static buffers of "
                             f"{self.n} (slope {self.slope})")
        self.fwd.load(op.fwd)
        self.bwd.load(op.bwd)
        copy_into(self.bwd_eid, op.bwd_eid)
        return self


class _PackedGatRaw(torch.autograd.Function):
    """(d, s, h) -> (raw num‖den, the shift's ``m``); the backward takes
    the forward's ``m`` as a constant and gives the seed no gradient."""

    @staticmethod
    def forward(ctx, d, s, h, seed, op, rate):
        d, s, h = (t.contiguous() for t in (d, s, h))
        acc, m = packed_gat_fwd(op.fwd, d, s, h, seed, rate, op.slope)
        ctx.save_for_backward(d, s, h, m, seed)
        ctx.op, ctx.rate = op, rate
        ctx.mark_non_differentiable(m)
        return acc, m

    @staticmethod
    def backward(ctx, g, _):
        d, s, h, m, seed = ctx.saved_tensors
        op = ctx.op
        dd, ds, dh = packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m,
                                    seed, g.contiguous(), ctx.rate, op.slope)
        return dd, ds, dh, None, None, None
