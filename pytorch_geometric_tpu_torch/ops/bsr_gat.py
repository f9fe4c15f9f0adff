"""Block-sparse fused GAT attention: whole layer, any number of nodes.

Counterpart of ``pytorch_geometric_tpu/ops/bsr_gat.py`` (``BsrFlashGat``),
with the same call contract. It computes the function of the dense-mask
operator (``ops/flash_gat.py``: leaky rank-1 logits, masked row softmax
with a saved log-sum-exp, dropout hashed from (seed, global row, global
column, head), ``out`` and the gradients ``dd``, ``ds``, ``dh``), but it
keeps only the mask's active blocks, so memory and work follow the entries
and not N^2, and the dense operator's cap of 8192 nodes is gone. For one
mask, seed and rate both operators agree, whatever the tile.

:class:`BlockMask` cuts the (N, N) mask into (tile_i, tile_j) blocks and
keeps those with an entry, bit-packed (one bit per entry, 32 columns a
word), in row-strip order with a pointer per strip; the transposed mask is
blocked the same way for the backward's column pass (on its own, with the
same tile: a block's transpose would force ``tile_i`` to whole words). It
is built on the host from the entry list; no (N, N) array is ever made.
Reordering the nodes first (``utils/reorder.py``, RCM) gathers the
entries into fewer blocks.

:func:`bsr_gat_fwd`, :func:`bsr_gat_bwd_row` and :func:`bsr_gat_bwd_col`
wrap the hand-written CUDA kernels of ``csrc/bsr_gat.cu``, which replace
the Pallas kernels ``ops/bsr_gat.py:_fwd_kernel``, ``_bwd_row_kernel`` and
``_bwd_col_kernel``. Beside each: its plain PyTorch version over the
mask's entry list (segment sums by row and by column, O(entries x H x C)
memory) and ``.launches``, a count of kernel launches. A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel, or raises. ``D = <g, out>`` per (row, head) is computed inside
the row pass, which hands it to the column pass (the JAX operator computes
it outside its kernels).

Devices of the TPU that are not ported: ``mask_dtype`` (the blocks are bit
words here, not int8 or bf16 matrices), ``interpret``, the padding of N to
``lcm(tile_i, tile_j)`` (the last strip and tile are simply ragged), the
diagonal blocks forced active so that a sequential grid visits every
strip, and the ``first`` / ``last`` flags of that grid: here each output
row has its own group of lanes, and a strip without blocks gives zeros.
"""

from typing import NamedTuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.flash_gat import (
    _check, _launched, hash_keep_bits)
from pytorch_geometric_tpu_torch.ops.packed_gat import (
    _launch_args, _leaky, dropout_scale, dropout_threshold, seed_tensor)
from pytorch_geometric_tpu_torch.ops.segment import segment_max, segment_sum

#: (tile_i, tile_j) of a block: the fastest of the tiles swept on an H100 at
#: PubMed's RCM-ordered mask (``chip_smoke.py``'s ``kernel_sweep`` line;
#: PERF.md). A row's group fetches one row of words from every block of its
#: strip, so a block more than one row high costs it the zero words that
#: the strip's other rows made active; one word wide keeps a 0.02%-dense
#: mask near one block per entry.
DEFAULT_TILE = (1, 32)


class Blocks(NamedTuple):
    """One direction of a block mask. ``strip_ptr`` int32 (strips + 1,):
    strip r owns blocks ``strip_ptr[r]`` to ``strip_ptr[r + 1]``;
    ``block_col`` int32 (K,): a block's column tile; ``words`` int32
    (K, tile_i, tile_j / 32): column ``32 w + b`` of the tile in bit b of
    a row's word w."""
    strip_ptr: torch.Tensor
    block_col: torch.Tensor
    words: torch.Tensor


def _block_layout(rows, cols, n: int, ti: int, tj: int) -> Blocks:
    """The active blocks of the unique entries ``(rows, cols)``, on the
    host, in strip-major order."""
    wj = tj // 32
    strips, tiles = -(-n // ti), -(-n // tj)
    uniq, k = np.unique((rows // ti) * tiles + cols // tj,
                        return_inverse=True)
    if uniq.size >= 2 ** 31:
        raise ValueError("more than 2^31 - 1 blocks: int32 strip pointers "
                         "cannot address them")
    # the entries of one word are neighbours once sorted by word: OR them
    flat = (k * ti + rows % ti) * wj + (cols % tj) // 32
    order = np.argsort(flat, kind="stable")
    word_ids, first = np.unique(flat[order], return_index=True)
    bit = np.left_shift(np.uint32(1), (cols % 32).astype(np.uint32))
    words = np.zeros(uniq.size * ti * wj, dtype=np.uint32)
    if first.size:
        words[word_ids] = np.bitwise_or.reduceat(bit[order], first)
    strip_ptr = np.searchsorted(uniq // tiles, np.arange(strips + 1))
    return Blocks(torch.from_numpy(strip_ptr.astype(np.int32)),
                  torch.from_numpy((uniq % tiles).astype(np.int32)),
                  torch.from_numpy(words.view(np.int32)
                                   .reshape(uniq.size, ti, wj)))


class BlockMask:
    """A square boolean mask as its active blocks, in the layout the
    kernels read: ``row``, the :class:`Blocks` of the mask (forward and
    the backward's row pass), and ``col``, those of its transpose (column
    pass). ``rows[e], cols[e]`` are the entries (an edge ``cols[e] ->
    rows[e]``); duplicates collapse."""

    def __init__(self, rows, cols, n: int, tile_i: int = DEFAULT_TILE[0],
                 tile_j: int = DEFAULT_TILE[1], device="cpu"):
        if tile_i < 1 or tile_j < 32 or tile_j % 32:
            raise ValueError(f"tile_i must be positive and tile_j a "
                             f"multiple of 32, got ({tile_i}, {tile_j})")
        rows = host_array(rows).astype(np.int64)
        cols = host_array(cols).astype(np.int64)
        if rows.shape != cols.shape or rows.ndim != 1:
            raise ValueError(f"rows {rows.shape} and cols {cols.shape} must "
                             "be 1-D of one length")
        if rows.size and (min(rows.min(), cols.min()) < 0
                          or max(rows.max(), cols.max()) >= n):
            raise ValueError(f"entry out of range [0, {n})")
        key = np.unique(rows * n + cols)
        rows, cols = key // n, key % n
        self.n, self.ti, self.tj = int(n), int(tile_i), int(tile_j)
        self.num_entries = int(key.size)
        self.row = Blocks(*(t.to(device) for t in
                            _block_layout(rows, cols, n, tile_i, tile_j)))
        self.col = Blocks(*(t.to(device) for t in
                            _block_layout(cols, rows, n, tile_i, tile_j)))
        self._entries = None

    @property
    def num_blocks(self) -> int:
        """Active blocks of the mask (its transpose may hold another
        number)."""
        return int(self.row.block_col.shape[0])

    @property
    def density(self) -> float:
        """Active blocks over all blocks of the tiling."""
        return self.num_blocks / (-(-self.n // self.ti)
                                  * -(-self.n // self.tj))

    def tensors(self):
        """Every tensor the kernels read."""
        return [*self.row, *self.col]

    def entries(self):
        """``(rows, cols)`` of the mask's entries, int64 on the mask's
        device in row-major order, decoded from the blocks (once, then
        kept)."""
        if self._entries is None:
            strip_ptr, block_col, words = self.row
            K, ti, wj = words.shape
            dev = words.device
            flat_words = words.reshape(-1)
            at = flat_words.nonzero()[:, 0]
            shifts = torch.arange(32, dtype=torch.int32, device=dev)
            which, bit = ((flat_words[at, None] >> shifts) & 1).nonzero(
                as_tuple=True)
            at = at[which]
            k, li, w = at // (ti * wj), (at // wj) % ti, at % wj
            strip = torch.repeat_interleave(
                torch.arange(strip_ptr.shape[0] - 1, device=dev),
                (strip_ptr[1:] - strip_ptr[:-1]).long())
            rows = strip[k] * ti + li
            cols = (block_col[k].long() * wj + w) * 32 + bit
            order = torch.argsort(rows * self.n + cols)
            self._entries = rows[order], cols[order]
        return self._entries


def _entry_terms(mask: BlockMask, d, s, seed, rate, slope):
    """Per-entry (V, H) terms: row and column ids, the pre-activation
    logit, the activated logit and keep * scale (a tensor, or the float
    scale where nothing is dropped)."""
    rows, cols = mask.entries()
    zpre = d[rows] + s[cols]
    thresh, scale = dropout_threshold(rate), dropout_scale(rate)
    if thresh == 0:
        return rows, cols, zpre, _leaky(zpre, slope), scale
    heads = torch.arange(d.shape[1], device=d.device)
    bits = hash_keep_bits(seed.long(), rows[:, None], cols[:, None],
                          heads[None])
    return (rows, cols, zpre, _leaky(zpre, slope),
            torch.where(bits >= thresh, scale, 0.0).float())


def bsr_gat_fwd_plain(mask: BlockMask, d, s, h, seed, rate: float = 0.0,
                      slope: float = 0.2):
    """``(out, lse)`` over the mask's entry list, in plain PyTorch: the
    forward kernel's reference."""
    n, H = d.shape
    C = h.shape[1] // H
    rows, cols, _, z, ks = _entry_terms(mask, d, s, seed, rate, slope)
    m = segment_max(z, rows, n)             # 0 for a row without entries
    p = torch.exp(z - m[rows])
    l = segment_sum(p, rows, n).clamp_min(1e-20)
    num = segment_sum((p * ks)[:, :, None] * h.view(n, H, C)[cols], rows, n)
    return (num / l[:, :, None]).reshape(n, H * C), m + torch.log(l)


def _dz_terms(mask, d, s, h, lse, big_d, g, seed, rate, slope):
    """Per entry: row, column, the gradient ``dz`` of the pre-activation
    logit and ``beta = alpha keep scale``, (V, H) each."""
    n, H = d.shape
    C = h.shape[1] // H
    rows, cols, zpre, z, ks = _entry_terms(mask, d, s, seed, rate, slope)
    alpha = torch.exp(z - lse[rows])
    dot = (g.view(n, H, C)[rows] * h.view(n, H, C)[cols]).sum(-1)
    dz = alpha * (ks * dot - big_d[rows])
    return rows, cols, torch.where(zpre > 0, dz, slope * dz), alpha * ks


def bsr_gat_bwd_row_plain(mask: BlockMask, d, s, h, lse, out, g, seed,
                          rate: float = 0.0, slope: float = 0.2):
    """``(dd, D)``, the row sums of ``dz`` and ``D = <g, out>`` per (row,
    head), in plain PyTorch: the row-pass kernel's reference."""
    n, H = d.shape
    C = h.shape[1] // H
    big_d = (g * out).view(n, H, C).sum(-1)
    rows, _, dz, _ = _dz_terms(mask, d, s, h, lse, big_d, g, seed, rate,
                               slope)
    return segment_sum(dz, rows, n), big_d


def bsr_gat_bwd_col_plain(mask: BlockMask, d, s, h, lse, big_d, g, seed,
                          rate: float = 0.0, slope: float = 0.2):
    """``(ds, dh)``, the column sums of ``dz`` and of ``alpha keep scale
    g``, from the row pass's ``D``, in plain PyTorch: the column-pass
    kernel's reference."""
    n, H = d.shape
    C = h.shape[1] // H
    rows, cols, dz, beta = _dz_terms(mask, d, s, h, lse, big_d, g, seed,
                                     rate, slope)
    dh = segment_sum(beta[:, :, None] * g.view(n, H, C)[rows], cols, n)
    return segment_sum(dz, cols, n), dh.reshape(n, H * C)


def bsr_gat_bwd_plain(mask: BlockMask, d, s, h, lse, out, g, seed,
                      rate: float = 0.0, slope: float = 0.2):
    """``(dd, ds, dh)`` from ``g``, the gradient of ``out``, and the
    forward's ``lse`` and ``out``: both passes' plain versions."""
    dd, big_d = bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g, seed, rate,
                                      slope)
    ds, dh = bsr_gat_bwd_col_plain(mask, d, s, h, lse, big_d, g, seed, rate,
                                   slope)
    return dd, ds, dh


def _launch(wrapper, entry: str, blocks: Blocks, mask: BlockMask, tensors,
            H: int, C: int, rate, slope, device):
    """One launch of ``entry`` of the library over ``blocks`` on the
    current stream of ``device``; a refused launch raises, a made one is
    counted on ``wrapper``."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    lib = load_library("bsr_gat")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in blocks), *(t.data_ptr() for t in tensors),
            mask.n, mask.ti, mask.tj // 32, H, C,
            *_launch_args(rate, slope, stream))
    _launched(wrapper, "kernel", rc)


def bsr_gat_fwd(mask: BlockMask, d, s, h, seed, rate: float = 0.0,
                slope: float = 0.2):
    """``(out, lse)``, (N, H*C) and (N, H): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. ``seed`` is one int32,
    read by the kernel from device memory."""
    n, H, C, device = _check(mask, d, s, h, seed, mask_type=BlockMask)
    if device.type == "cpu":
        return bsr_gat_fwd_plain(mask, d, s, h, seed, rate, slope)
    out = torch.empty((n, H * C), dtype=torch.float32, device=device)
    lse = torch.empty((n, H), dtype=torch.float32, device=device)
    _launch(bsr_gat_fwd, "bsr_gat_fwd", mask.row, mask,
            (d, s, h, seed, out, lse), H, C, rate, slope, device)
    return out, lse


def bsr_gat_bwd_row(mask: BlockMask, d, s, h, lse, out, g, seed,
                    rate: float = 0.0, slope: float = 0.2):
    """``(dd, D)`` over the mask's blocks: the row-pass kernel on CUDA
    tensors, its plain version on CPU tensors."""
    n, H, C, device = _check(mask, d, s, h, seed,
                             (("lse", lse), ("out", out), ("g", g)),
                             mask_type=BlockMask)
    if device.type == "cpu":
        return bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g, seed, rate,
                                     slope)
    dd, big_d = (torch.empty((n, H), dtype=torch.float32, device=device)
                 for _ in range(2))
    _launch(bsr_gat_bwd_row, "bsr_gat_bwd_row", mask.row, mask,
            (d, s, h, lse, out, g, seed, dd, big_d), H, C, rate, slope,
            device)
    return dd, big_d


def bsr_gat_bwd_col(mask: BlockMask, d, s, h, lse, big_d, g, seed,
                    rate: float = 0.0, slope: float = 0.2):
    """``(ds, dh)`` over the transposed mask's blocks, from the row pass's
    ``D``: the column-pass kernel on CUDA tensors, its plain version on
    CPU tensors."""
    n, H, C, device = _check(mask, d, s, h, seed,
                             (("lse", lse), ("D", big_d), ("g", g)),
                             mask_type=BlockMask)
    if device.type == "cpu":
        return bsr_gat_bwd_col_plain(mask, d, s, h, lse, big_d, g, seed,
                                     rate, slope)
    ds = torch.empty((n, H), dtype=torch.float32, device=device)
    dh = torch.empty((n, H * C), dtype=torch.float32, device=device)
    _launch(bsr_gat_bwd_col, "bsr_gat_bwd_col", mask.col, mask,
            (d, s, h, lse, big_d, g, seed, ds, dh), H, C, rate, slope,
            device)
    return ds, dh


def bsr_gat_bwd(mask: BlockMask, d, s, h, lse, out, g, seed,
                rate: float = 0.0, slope: float = 0.2):
    """``(dd, ds, dh)``: the row pass, then the column pass on the same
    stream (two launches on CUDA tensors)."""
    dd, big_d = bsr_gat_bwd_row(mask, d, s, h, lse, out, g, seed, rate,
                                slope)
    ds, dh = bsr_gat_bwd_col(mask, d, s, h, lse, big_d, g, seed, rate, slope)
    return dd, ds, dh


#: Launches of each CUDA kernel; the CPU path never adds to them.
bsr_gat_fwd.launches = 0
bsr_gat_bwd_row.launches = 0
bsr_gat_bwd_col.launches = 0


class BsrFlashGat:
    """Fused GAT attention over the active blocks of one static mask.

    Built once per graph and shared by every layer that uses it; same
    call contract as the JAX operator, ``FlashGatOperator`` and
    ``PackedFlashGat``::

        op = BsrFlashGat(adj_bool)                    # bool (N, N)
        op = BsrFlashGat.from_edges(*gat_edge_set(graph), graph.num_nodes)
        out = op(d, s, h2d, seed, rate=0.6)           # (N, H*C) float32

    ``adj_bool[i, j]`` is true for an edge j -> i, self loops included; it
    need not be symmetric. :meth:`from_edges` takes the same entries as
    ``(senders, receivers)`` for graphs whose (N, N) matrix must not be
    built. ``d`` / ``s`` are the receiver and sender halves of the logits,
    (N, H); ``seed`` is an int or a one-element integer tensor on the
    device. The result does not depend on the tile. ``num_blocks`` and
    ``density`` count the mask's active blocks, as in the JAX operator
    (which also counts its forced diagonal blocks)."""

    def __init__(self, adj_bool, negative_slope: float = 0.2,
                 tile_i: int = DEFAULT_TILE[0],
                 tile_j: int = DEFAULT_TILE[1], *, device="cuda"):
        adj = host_array(adj_bool)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adj must be a square matrix, got "
                             f"{tuple(adj.shape)}")
        rows, cols = np.nonzero(adj)
        self._setup(rows, cols, adj.shape[0], negative_slope, tile_i, tile_j,
                    device)

    @classmethod
    def from_edges(cls, senders, receivers, num_nodes: int,
                   negative_slope: float = 0.2,
                   tile_i: int = DEFAULT_TILE[0],
                   tile_j: int = DEFAULT_TILE[1], *, device="cuda"):
        """The operator of the mask with an entry (receiver, sender) per
        edge, from the edge list alone."""
        op = cls.__new__(cls)
        op._setup(receivers, senders, num_nodes, negative_slope, tile_i,
                  tile_j, device)
        return op

    def _setup(self, rows, cols, n, negative_slope, tile_i, tile_j, device):
        from pytorch_geometric_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.mask = BlockMask(rows, cols, n, tile_i, tile_j, self.device)
        self.n = self.mask.n
        self.ti, self.tj = self.mask.ti, self.mask.tj
        self.slope = float(negative_slope)
        self._seeds = {}

    @property
    def num_blocks(self) -> int:
        return self.mask.num_blocks

    @property
    def density(self) -> float:
        return self.mask.density

    def __call__(self, d, s, h2d, seed, rate: float = 0.0,
                 raw_out: bool = False):
        if raw_out:
            raise NotImplementedError(
                "raw_out is only supported by the packed backend "
                "(PackedFlashGat); use backend='packed' for raw_out")
        return _BsrGat.apply(
            d, s, h2d, seed_tensor(self._seeds, seed, d.device), self,
            float(rate))


class _BsrGat(torch.autograd.Function):
    """(d, s, h) -> out; the backward rebuilds the attention weights from
    the saved log-sum-exp and gives the seed no gradient."""

    @staticmethod
    def forward(ctx, d, s, h, seed, op, rate):
        d, s, h = (t.contiguous() for t in (d, s, h))
        out, lse = bsr_gat_fwd(op.mask, d, s, h, seed, rate, op.slope)
        ctx.save_for_backward(d, s, h, lse, out, seed)
        ctx.op, ctx.rate = op, rate
        return out

    @staticmethod
    def backward(ctx, g):
        d, s, h, lse, out, seed = ctx.saved_tensors
        op = ctx.op
        dd, ds, dh = bsr_gat_bwd(op.mask, d, s, h, lse, out, g.contiguous(),
                                 seed, ctx.rate, op.slope)
        return dd, ds, dh, None, None, None
