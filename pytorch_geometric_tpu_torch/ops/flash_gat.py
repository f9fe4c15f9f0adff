"""Dense-mask fused GAT attention: masked row softmax and aggregation.

Counterpart of ``pytorch_geometric_tpu/ops/flash_gat.py``
(``FlashGatOperator``), with the same call contract and numerics. Per
head, over an (N, N) boolean mask ``adj[i, j]`` (edge j -> i):

- logits ``z = leaky(d[i] + s[j])`` where ``adj[i, j]``; the row maximum
  ``m``, ``p = exp(z - m)`` and the row sum ``l`` over all valid entries;
- attention dropout from :func:`hash_keep_bits`, a stateless hash of
  (seed, row, column, head), so the forward and both backward passes drop
  the same entries without storing N^2 bits; dropout acts on the
  normalised weights (the sum ``l`` is taken before it);
- ``out = (sum_j keep p h[j]) * scale / max(l, 1e-20)``, and the saved
  log-sum-exp ``lse = m + log(max(l, 1e-20))``, from which the backward
  rebuilds ``alpha = exp(z - lse)``. A row without a valid entry gives 0.

The JAX package keeps the mask as a padded bf16 0/1 matrix for the TPU.
Here :class:`BitMask` packs it, and its transpose, into 32-bit words, one
bit per entry (1.2 MB each at 3072 nodes): the kernels walk a row's set
bits, so a sparse mask costs little more than its edges and any mask,
symmetric or not, is right.

:func:`flash_gat_fwd` and :func:`flash_gat_bwd` wrap the hand-written
CUDA kernels of ``csrc/flash_gat.cu``, which replace the Pallas kernels
``ops/flash_gat.py:_fwd_kernel`` and ``_bwd_kernel``. Beside them: their
plain PyTorch versions on the dense mask and ``.launches``, a count of
kernel launches. A wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches its kernels, or raises.
"""

import torch

from pytorch_geometric_tpu_torch.ops.packed_gat import (
    _MASK32, _launch_args, _leaky, dropout_scale, dropout_threshold,
    seed_tensor)

#: The operator is for small graphs: the mask grows with N^2.
MAX_NODES = 8192


def hash_keep_bits(seed, row, col, head):
    """uint32 dropout bits per (row, column, head), as int64 tensors that
    broadcast: the hash of ``ops/flash_gat.py:_hash_keep_bits``, with
    ``& 0xFFFFFFFF`` after each product (every product stays below 2^63
    for coordinates and seeds below 2^31)."""
    m = _MASK32
    x = (((row * 0x9E3779B1) & m) ^ ((col * 0x85EBCA77) & m)
         ^ ((((seed * 0xC2B2AE3D) & m) + ((head * 0x27D4EB2F) & m)) & m))
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & m
    x = ((x ^ (x >> 12)) * 0x297A2D39) & m
    return x ^ (x >> 15)


def pack_mask(adj):
    """Bit-pack a boolean (N, M) mask into (N, ceil(M / 32)) int32 words:
    column ``32 w + b`` of a row sits in bit ``b`` of its word ``w``; the
    bits past column M are 0."""
    n, m = adj.shape
    words = (m + 31) // 32
    padded = torch.zeros((n, words * 32), dtype=torch.uint8,
                         device=adj.device)
    padded[:, :m] = adj
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=adj.device)
    octets = (padded.view(n, words * 4, 8) * weights).sum(
        -1, dtype=torch.uint8)
    return octets.view(torch.int32)        # little-endian: octet 0 is low


def unpack_mask(bits, num_cols: int):
    """The boolean (N, ``num_cols``) mask of :func:`pack_mask`'s words."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    dense = (bits[:, :, None] >> shifts) & 1
    return dense.reshape(bits.shape[0], -1)[:, :num_cols].bool()


class BitMask:
    """A square boolean mask in the layout the kernels read: ``bits``
    (N, W) int32 by rows, for the forward and the backward's row pass, and
    ``bits_t``, the transpose's rows, for the column pass."""

    def __init__(self, adj):
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1] \
                or adj.dtype != torch.bool:
            raise ValueError(f"adj must be a square bool matrix, got "
                             f"{adj.dtype} {tuple(adj.shape)}")
        self.n = int(adj.shape[0])
        self.bits = pack_mask(adj)
        self.bits_t = pack_mask(adj.t())

    @property
    def words(self) -> int:
        return int(self.bits.shape[1])

    def dense(self):
        """The (N, N) boolean mask."""
        return unpack_mask(self.bits, self.n)

    def tensors(self):
        """Every tensor the kernels read."""
        return [self.bits, self.bits_t]


def _head_terms(adj, d, s, seed, hd, rate, slope):
    """One head's (N, N) terms: the pre-activation logit, the activated
    logit with -inf at invalid entries, and keep * scale (a tensor, or
    the float scale where nothing is dropped)."""
    zpre = d[:, hd, None] + s[None, :, hd]
    z = torch.where(adj, _leaky(zpre, slope), -torch.inf)
    thresh, scale = dropout_threshold(rate), dropout_scale(rate)
    if thresh == 0:
        return zpre, z, scale
    idx = torch.arange(adj.shape[0], device=d.device)
    bits = hash_keep_bits(seed.long(), idx[:, None], idx[None], hd)
    return zpre, z, torch.where(bits >= thresh, scale, 0.0).float()


def flash_gat_fwd_plain(adj, d, s, h, seed, rate: float = 0.0,
                        slope: float = 0.2):
    """``(out, lse)`` over the dense boolean mask ``adj``, in plain
    PyTorch: the forward kernel's reference. It goes head by head, so one
    (N, N) temporary is live, not (H, N, N)."""
    n, H = d.shape
    C = h.shape[1] // H
    out = torch.empty((n, H * C), dtype=torch.float32, device=d.device)
    lse = torch.empty((n, H), dtype=torch.float32, device=d.device)
    any_valid = adj.any(dim=1, keepdim=True)
    for hd in range(H):
        cols = slice(hd * C, (hd + 1) * C)
        _, z, ks = _head_terms(adj, d, s, seed, hd, rate, slope)
        m = torch.where(any_valid, z.amax(dim=1, keepdim=True), 0.0)
        p = torch.exp(z - m)                    # 0 at invalid entries
        l = p.sum(dim=1, keepdim=True).clamp_min(1e-20)
        out[:, cols] = ((p * ks) @ h[:, cols]) / l
        lse[:, hd] = (m + torch.log(l))[:, 0]
    return out, lse


def flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, rate: float = 0.0,
                        slope: float = 0.2):
    """``(dd, ds, dh)`` from ``g``, the gradient of ``out``, and the
    forward's ``lse`` and ``out``, in plain PyTorch: the backward kernels'
    reference."""
    n, H = d.shape
    C = h.shape[1] // H
    dd = torch.empty((n, H), dtype=torch.float32, device=d.device)
    ds = torch.empty((n, H), dtype=torch.float32, device=d.device)
    dh = torch.empty((n, H * C), dtype=torch.float32, device=d.device)
    for hd in range(H):
        cols = slice(hd * C, (hd + 1) * C)
        zpre, z, ks = _head_terms(adj, d, s, seed, hd, rate, slope)
        alpha = torch.exp(z - lse[:, hd, None])      # 0 at invalid entries
        gh = g[:, cols]
        big_d = (gh * out[:, cols]).sum(dim=1, keepdim=True)
        dz = alpha * (ks * (gh @ h[:, cols].t()) - big_d)
        dz = torch.where(zpre > 0, dz, slope * dz)
        dd[:, hd] = dz.sum(dim=1)
        ds[:, hd] = dz.sum(dim=0)
        dh[:, cols] = (alpha * ks).t() @ gh
    return dd, ds, dh


def _check(mask, d, s, h, seed, extra=(), mask_type=BitMask):
    """Shapes, types and devices of a call over a ``mask_type`` (default
    :class:`BitMask`; ``ops/bsr_gat.py`` checks its block mask here too);
    ``extra`` holds (name, tensor) of the backward's further float
    inputs."""
    if not isinstance(mask, mask_type):
        raise TypeError(f"mask must be a {mask_type.__name__}, got "
                        f"{type(mask).__name__}")
    n, H = d.shape if d.ndim == 2 else (None, None)
    if not n or H == 0 or s.shape != (n, H) or h.ndim != 2 \
            or h.shape[0] != n or h.shape[1] == 0 or h.shape[1] % H:
        raise ValueError(f"d and s must be (N, H) and h (N, H*C), got "
                         f"{tuple(d.shape)}, {tuple(s.shape)}, "
                         f"{tuple(h.shape)}")
    if mask.n != n:
        raise ValueError(f"the mask is ({mask.n}, {mask.n}), the inputs "
                         f"have {n} rows")
    C = h.shape[1] // H
    if seed.shape != (1,) or seed.dtype != torch.int32:
        raise TypeError(f"seed must be one int32, got {seed.dtype} "
                        f"{tuple(seed.shape)}")
    shapes = {"lse": (n, H), "D": (n, H), "out": (n, H * C),
              "g": (n, H * C)}
    for name, t in extra:
        if t.shape != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    floats = [d, s, h] + [t for _, t in extra]
    for t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("d, s, h, lse, out, D and g must be contiguous "
                            "float32")
    devices = {t.device for t in floats + [seed, *mask.tensors()]}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked GAT attention runs on cpu or cuda, not "
                         f"{device}")
    return n, H, C, device


def _launched(wrapper, what, rc):
    """Raise on a refused launch (``rc``: cudaGetLastError), else count
    it."""
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} {what} launch failed: CUDA "
                           f"error {rc}")
    wrapper.launches += 1


def flash_gat_fwd(mask: BitMask, d, s, h, seed, rate: float = 0.0,
                  slope: float = 0.2):
    """``(out, lse)``, (N, H*C) and (N, H): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. ``seed`` is one int32,
    read by the kernel from device memory."""
    n, H, C, device = _check(mask, d, s, h, seed)
    if device.type == "cpu":
        return flash_gat_fwd_plain(mask.dense(), d, s, h, seed, rate, slope)
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("flash_gat")
    out = torch.empty((n, H * C), dtype=torch.float32, device=device)
    lse = torch.empty((n, H), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_gat_fwd(
            mask.bits.data_ptr(), d.data_ptr(), s.data_ptr(), h.data_ptr(),
            seed.data_ptr(), out.data_ptr(), lse.data_ptr(), n, mask.words,
            H, C, *_launch_args(rate, slope, stream))
    _launched(flash_gat_fwd, "kernel", rc)
    return out, lse


def flash_gat_bwd(mask: BitMask, d, s, h, lse, out, g, seed,
                  rate: float = 0.0, slope: float = 0.2):
    """``(dd, ds, dh)``: on CUDA tensors two launches, the row pass over
    the mask (``dd``, and ``D = <g, out>`` per head) and the column pass
    over its transpose (``ds``, ``dh``); on CPU tensors the plain
    version."""
    n, H, C, device = _check(mask, d, s, h, seed,
                             (("lse", lse), ("out", out), ("g", g)))
    if device.type == "cpu":
        return flash_gat_bwd_plain(mask.dense(), d, s, h, lse, out, g, seed,
                                   rate, slope)
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("flash_gat")
    dd, ds, big_d = (torch.empty((n, H), dtype=torch.float32, device=device)
                     for _ in range(3))
    dh = torch.empty((n, H * C), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tail = (n, mask.words, H, C, *_launch_args(rate, slope, stream))
        _launched(flash_gat_bwd, "row pass", lib.flash_gat_bwd_row(
            mask.bits.data_ptr(), d.data_ptr(), s.data_ptr(), h.data_ptr(),
            lse.data_ptr(), out.data_ptr(), g.data_ptr(), seed.data_ptr(),
            dd.data_ptr(), big_d.data_ptr(), *tail))
        _launched(flash_gat_bwd, "column pass", lib.flash_gat_bwd_col(
            mask.bits_t.data_ptr(), d.data_ptr(), s.data_ptr(), h.data_ptr(),
            lse.data_ptr(), big_d.data_ptr(), g.data_ptr(), seed.data_ptr(),
            ds.data_ptr(), dh.data_ptr(), *tail))
    return dd, ds, dh


#: Launches of the CUDA kernels; the CPU path never adds to them. The
#: backward counts each of its two launches.
flash_gat_fwd.launches = 0
flash_gat_bwd.launches = 0


class FlashGatOperator:
    """Fused GAT attention over one static dense mask.

    Built once per graph and shared by every layer that uses it; same
    call contract as the JAX operator and as ``PackedFlashGat``::

        op = FlashGatOperator(gat_dense_adj(graph))
        out = op(d, s, h2d, seed, rate=0.6)          # (N, H*C) float32

    ``adj_bool[i, j]`` is true for an edge j -> i, self loops included; it
    need not be symmetric. ``d`` / ``s`` are the receiver and sender
    halves of the logits, (N, H); ``seed`` is an int or a one-element
    integer tensor on the device (the training path draws it there, so
    nothing waits on the card). The mask lives bit-packed on ``device``.
    """

    def __init__(self, adj_bool, negative_slope: float = 0.2, *,
                 device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        adj = torch.as_tensor(adj_bool).to(self.device)
        self.mask = BitMask(adj if adj.dtype == torch.bool else adj != 0)
        self.n = self.mask.n
        self.slope = float(negative_slope)
        self._seeds = {}

    def __call__(self, d, s, h2d, seed, rate: float = 0.0,
                 raw_out: bool = False):
        if raw_out:
            raise NotImplementedError(
                "raw_out is only supported by the packed backend "
                "(PackedFlashGat); use backend='packed' for raw_out")
        return _FlashGat.apply(
            d, s, h2d, seed_tensor(self._seeds, seed, d.device), self,
            float(rate))


class _FlashGat(torch.autograd.Function):
    """(d, s, h) -> out; the backward rebuilds the attention weights from
    the saved log-sum-exp and gives the seed no gradient."""

    @staticmethod
    def forward(ctx, d, s, h, seed, op, rate):
        d, s, h = (t.contiguous() for t in (d, s, h))
        out, lse = flash_gat_fwd(op.mask, d, s, h, seed, rate, op.slope)
        ctx.save_for_backward(d, s, h, lse, out, seed)
        ctx.op, ctx.rate = op, rate
        return out

    @staticmethod
    def backward(ctx, g):
        d, s, h, lse, out, seed = ctx.saved_tensors
        op = ctx.op
        dd, ds, dh = flash_gat_bwd(op.mask, d, s, h, lse, out,
                                   g.contiguous(), seed, ctx.rate, op.slope)
        return dd, ds, dh, None, None, None
