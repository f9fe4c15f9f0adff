"""Port parity, block-sparse GAT slice: the reorder utilities, the block
mask, ``BsrFlashGat`` (its kernels' plain versions on the CPU),
``GATConv(flash_op=BsrFlashGat)`` and the ``GAT`` trained with
``backend="bsr"``, against the JAX package run as its own tests run it on
the CPU (Pallas interpret mode) and against the port's dense-mask
operator.

Tolerances, relative to the largest reference magnitude:

- bit for bit: the RCM permutation, the reordered arrays, the window
  density, the mask's entry list;
- 2e-2 against the JAX ``BsrFlashGat``, which rounds its products to bf16;
  its gradients by relative L2 norm within 5e-2, as
  ``tests/test_torch_port_flash_gat.py`` gates the dense operator's;
- 1e-5 against ``flash_gat_fwd_plain`` / ``flash_gat_bwd_plain`` on the
  same mask (another order of the sums), 1e-6 against the port's
  ``FlashGatOperator`` output, and bit for bit between two tile shapes
  (the plain versions read the entry list, which no tile changes);
- 1e-5 against the JAX fp32 sparse ``GATConv``; 1e-4 for five AdamW steps
  against ``backend="packed"`` and for a reordered graph against the
  unreordered one.

Dropout is on wherever both sides hash it from the same (seed, row,
column, head); it is off against ``PackedFlashGat``, which hashes the edge
id instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.ops.bsr_gat import BsrFlashGat as JBsrFlashGat
from pytorch_geometric_tpu.utils import reorder as jreorder
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.nn.conv import (
    GATConv, gat_dense_adj, gat_edge_set)
from pytorch_geometric_tpu_torch.ops import bsr_gat as bg
from pytorch_geometric_tpu_torch.ops import flash_gat as fg
from pytorch_geometric_tpu_torch.ops import packed_gat as pg
from pytorch_geometric_tpu_torch.utils import reorder

F_IN, CLASSES = 12, 4
TILES = [(8, 32), (1, 32), (5, 96), (16, 64), (512, 512)]


def _arrays(seed=0, n=150, e=500):
    """A banded graph under a random relabelling (so RCM has something to
    find), without duplicate edges, with pre-existing self loops and,
    once padded, padding nodes and edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-6, 7, e), 0, n - 1)
    shuffle = rng.permutation(n)
    ei = np.stack([shuffle[src], shuffle[dst]])
    loops = np.tile(np.arange(6), (2, 1))
    ei = np.unique(np.concatenate([ei, loops], axis=1), axis=1)
    return dict(x=rng.normal(size=(n, F_IN)).astype(np.float32),
                edge_index=ei, y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.4, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


def _mask(seed, n, density=0.05, empty_rows=(), empty_cols=()):
    """A directed boolean mask with a diagonal, apart from the named rows
    and columns, which hold no entry."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < density) | np.eye(n, dtype=bool)
    adj[list(empty_rows), :] = False
    adj[:, list(empty_cols)] = False
    assert not np.array_equal(adj, adj.T)
    return adj


def _node_inputs(seed, n, H, C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _port_vjp(op, d, s, h, proj, seed, rate):
    ts = [torch.from_numpy(a).requires_grad_() for a in (d, s, h)]
    out = op(*ts, seed, rate=rate)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach(), [t.grad for t in ts]


# ---------------------------------------------------------------------------
# utils/reorder.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,e", [(0, 150, 500), (1, 400, 1500),
                                      (2, 700, 1200)])
def test_rcm_permutation_and_window_density_match_jax(seed, n, e):
    ei = _arrays(seed, n, e)["edge_index"]
    perm = reorder.rcm_permutation(ei[0], ei[1], n)
    np.testing.assert_array_equal(
        perm, jreorder.rcm_permutation(ei[0], ei[1], n))
    assert sorted(perm.tolist()) == list(range(n))
    inv = np.argsort(perm)
    for window in (32, 256):
        for s, r in ((ei[0], ei[1]), (inv[ei[0]], inv[ei[1]])):
            assert reorder.window_density(s, r, n, window) == \
                jreorder.window_density(s, r, n, window)
    # the banded graph comes back: fewer, fuller buckets
    before = reorder.window_density(ei[0], ei[1], n, 32)
    after = reorder.window_density(inv[ei[0]], inv[ei[1]], n, 32)
    assert after[0] < before[0] and after[1] > before[1]


@pytest.mark.parametrize("given_perm", [False, True])
def test_reorder_graph_matches_jax(given_perm):
    arrays = _arrays(3)
    n = arrays["x"].shape[0]
    perm = np.random.default_rng(3).permutation(n) if given_perm else None
    extra = dict(pos=arrays["x"][:, :3], edge_attr=np.arange(
        arrays["edge_index"].shape[1], dtype=np.float32))
    got = reorder.reorder_graph(Data(**arrays, **extra), perm)
    want = jreorder.reorder_graph(JData(**arrays, **extra), perm)
    assert sorted(got.keys) == sorted(want.keys)
    for key in got.keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # edge attributes stay with their edges; the labels moved with x
    np.testing.assert_array_equal(got.edge_attr, extra["edge_attr"])
    assert not np.array_equal(got.y, arrays["y"])


def test_reordering_makes_the_block_list_shorter_and_keeps_the_entries():
    arrays = _arrays(4, n=700, e=3000)
    plain = from_data(Data(**arrays), device="cpu")
    ordered = from_data(reorder.reorder_graph(Data(**arrays)), device="cpu")
    a = tcit.gat_flash_op(plain, "bsr")
    b = tcit.gat_flash_op(ordered, "bsr")
    assert a.mask.num_entries == b.mask.num_entries
    assert b.num_blocks < 0.6 * a.num_blocks
    assert 0 < b.density < a.density < 1


# ---------------------------------------------------------------------------
# the block mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("n", [1, 33, 100, 203])
def test_block_mask_round_trips_its_entry_list(n, tile):
    """N no multiple of the tile, empty rows and columns, a directed
    mask: ``entries()`` decodes the blocks back to the row-major entry
    list, the column blocks are the transpose's row blocks, and only
    blocks with an entry are kept."""
    ti, tj = tile
    adj = _mask(n, n, 0.06, empty_rows=(2, n - 1), empty_cols=(5,)) \
        if n > 6 else np.ones((n, n), dtype=bool)
    rows, cols = np.nonzero(adj)
    shuffle = np.random.default_rng(n).permutation(rows.size)
    mask = bg.BlockMask(np.concatenate([rows[shuffle], rows[:3]]),
                        np.concatenate([cols[shuffle], cols[:3]]), n, ti, tj)
    got_rows, got_cols = mask.entries()
    assert got_rows.dtype == torch.int64
    np.testing.assert_array_equal(got_rows.numpy(), rows)
    np.testing.assert_array_equal(got_cols.numpy(), cols)
    assert mask.num_entries == rows.size      # duplicates collapse
    transposed = bg.BlockMask(cols, rows, n, ti, tj)
    for a, b in zip(mask.col, transposed.row):
        assert torch.equal(a, b)
    # the layout: strip pointers over blocks that each hold an entry
    strip_ptr, block_col, words = mask.row
    strips, tiles = -(-n // ti), -(-n // tj)
    assert strip_ptr.dtype == block_col.dtype == words.dtype == torch.int32
    assert strip_ptr.shape == (strips + 1,) and int(strip_ptr[0]) == 0
    assert int(strip_ptr[-1]) == mask.num_blocks == block_col.shape[0]
    assert words.shape == (mask.num_blocks, ti, tj // 32)
    assert (words.reshape(mask.num_blocks, -1) != 0).any(dim=1).all()
    assert int(block_col.max()) < tiles
    want_blocks = len({(i // ti, j // tj) for i, j in zip(rows, cols)})
    assert mask.num_blocks == want_blocks
    assert mask.density == want_blocks / (strips * tiles)
    # column 32 w + b of a tile sits in bit b of word w
    i, j = int(rows[0]), int(cols[0])
    k = int(strip_ptr[i // ti]) + int(
        (block_col[strip_ptr[i // ti]:strip_ptr[i // ti + 1]]
         == j // tj).nonzero()[0, 0])
    assert (int(words[k, i % ti, (j % tj) // 32]) >> (j % 32)) & 1


def test_block_mask_refuses_bad_tiles_and_entries():
    for tile in ((0, 32), (8, 0), (8, 48), (8, 16)):
        with pytest.raises(ValueError, match="tile"):
            bg.BlockMask([0], [0], 4, *tile)
    with pytest.raises(ValueError, match="range"):
        bg.BlockMask([0, 4], [0, 1], 4)
    with pytest.raises(ValueError, match="range"):
        bg.BlockMask([0, 1], [0, -1], 4)
    with pytest.raises(ValueError, match="one length"):
        bg.BlockMask([0, 1], [0], 4)
    with pytest.raises(ValueError, match="square"):
        bg.BsrFlashGat(np.ones((3, 4), dtype=bool), device="cpu")
    empty = bg.BlockMask([], [], 10)
    assert empty.num_blocks == 0 and empty.entries()[0].numel() == 0


def test_both_constructors_build_one_mask():
    adj = _mask(5, 90)
    rows, cols = np.nonzero(adj)
    a = bg.BsrFlashGat(adj, tile_i=4, tile_j=64, device="cpu")
    b = bg.BsrFlashGat.from_edges(cols, rows, 90, tile_i=4, tile_j=64,
                                  device="cpu")
    c = bg.BsrFlashGat(torch.from_numpy(adj), device="cpu")
    assert (a.n, a.ti, a.tj) == (b.n, b.ti, b.tj) == (90, 4, 64)
    assert (c.ti, c.tj) == bg.DEFAULT_TILE
    assert a.num_blocks == b.num_blocks and a.density == b.density
    for x, y in zip(a.mask.tensors(), b.mask.tensors()):
        assert torch.equal(x, y)
    assert a.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the operator against the JAX package and the dense-mask operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("n,H,C", [(150, 2, 4), (300, 3, 5)])
def test_bsr_flash_gat_matches_jax_operator(n, H, C, rate):
    """Forward and grads of d, s and h on a directed mask with empty rows
    and columns and the same dropout seed: both hash the global (row,
    column, head), so the same entries are dropped."""
    adj = _mask(n + H, n, 0.04, empty_rows=(7,), empty_cols=(9, n - 2))
    d, s, h, proj = _node_inputs(n + C, n, H, C)
    seed = 11
    jop = JBsrFlashGat(adj, tile_i=128, tile_j=128)

    def loss(d, s, h):
        return jnp.sum(jop(d, s, h, float(seed), rate=rate) * proj)

    want = jop(d, s, h, float(seed), rate=rate)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(d, s, h)
    op = bg.BsrFlashGat(adj, device="cpu")
    got, grads = _port_vjp(op, d, s, h, proj, seed, rate)
    _close(got, want, 2e-2)
    for a, b in zip(grads, want_grads):
        # the JAX kernels round p, h, g and beta to bf16; disagreeing
        # dropout bits would move these by O(1)
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 5e-2 * np.linalg.norm(b)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("n,H,C", [(100, 8, 8), (203, 1, 7), (333, 3, 5)])
def test_bsr_matches_the_dense_mask_operator_whatever_the_tile(n, H, C,
                                                               rate):
    """One function of the mask: the plain versions against
    ``flash_gat_fwd_plain`` / ``flash_gat_bwd_plain`` (1e-5), the operator
    against the port's ``FlashGatOperator`` (1e-6 on the output), and two
    tile shapes bit for bit."""
    adj_np = _mask(n, n, 0.05, empty_rows=(3, n - 1), empty_cols=(8,))
    adj = torch.from_numpy(adj_np)
    d, s, h, g = [torch.from_numpy(a) for a in _node_inputs(n + 1, n, H, C)]
    seed = torch.tensor([77], dtype=torch.int32)
    rows, cols = np.nonzero(adj_np)
    masks = [bg.BlockMask(rows, cols, n, *tile) for tile in ((8, 32),
                                                             (5, 96))]
    out, lse = bg.bsr_gat_fwd_plain(masks[0], d, s, h, seed, rate)
    want_out, want_lse = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    _close(out, want_out.numpy(), 1e-5)
    _close(lse, want_lse.numpy(), 1e-5)
    grads = bg.bsr_gat_bwd_plain(masks[0], d, s, h, lse, out, g, seed, rate)
    for a, b in zip(grads, fg.flash_gat_bwd_plain(
            adj, d, s, h, want_lse, want_out, g, seed, rate)):
        _close(a, b.numpy(), 1e-5)
    assert (out[[3, n - 1]] == 0).all() and (grads[0][[3, n - 1]] == 0).all()
    assert (grads[1][8] == 0).all() and (grads[2][8] == 0).all()
    other = bg.bsr_gat_fwd_plain(masks[1], d, s, h, seed, rate)
    assert torch.equal(other[0], out) and torch.equal(other[1], lse)
    for a, b in zip(grads, bg.bsr_gat_bwd_plain(masks[1], d, s, h, lse, out,
                                                g, seed, rate)):
        assert torch.equal(a, b)
    dense = fg.FlashGatOperator(adj, device="cpu")
    bsr = bg.BsrFlashGat(adj, tile_i=16, tile_j=64, device="cpu")
    proj = g.numpy()
    want, want_grads = _port_vjp(dense, d.numpy(), s.numpy(), h.numpy(),
                                 proj, 77, rate)
    got, got_grads = _port_vjp(bsr, d.numpy(), s.numpy(), h.numpy(), proj,
                               77, rate)
    _close(got, want.numpy(), 1e-6)
    for a, b in zip(got_grads, want_grads):
        _close(a, b.numpy(), 1e-5)


def test_the_passes_split_the_backward_and_hand_over_d():
    n, H, C = 120, 2, 3
    adj = _mask(6, n)
    mask = bg.BlockMask(*np.nonzero(adj), n)
    d, s, h, g = [torch.from_numpy(a) for a in _node_inputs(6, n, H, C)]
    seed = torch.tensor([3], dtype=torch.int32)
    out, lse = bg.bsr_gat_fwd(mask, d, s, h, seed, 0.5)
    dd, big_d = bg.bsr_gat_bwd_row(mask, d, s, h, lse, out, g, seed, 0.5)
    ds, dh = bg.bsr_gat_bwd_col(mask, d, s, h, lse, big_d, g, seed, 0.5)
    _close(big_d, (g * out).view(n, H, C).sum(-1).numpy(), 1e-6)
    for a, b in zip((dd, ds, dh), bg.bsr_gat_bwd(mask, d, s, h, lse, out, g,
                                                 seed, 0.5)):
        assert torch.equal(a, b)
    # every (entry, head) feeds one row sum and one column sum
    _close(dd.sum(0), ds.sum(0).numpy(), 1e-5)


def test_operator_seeds_slope_and_raw_out():
    n, H, C = 60, 2, 3
    adj = _mask(10, n)
    d, s, h, _ = [torch.from_numpy(a) for a in _node_inputs(10, n, H, C)]
    a = bg.BsrFlashGat(adj, device="cpu")
    seed = torch.tensor([9], dtype=torch.int64)
    assert torch.equal(a(d, s, h, 9, rate=0.5), a(d, s, h, seed, rate=0.5))
    assert not torch.equal(a(d, s, h, 9, rate=0.5), a(d, s, h, 10, rate=0.5))
    other = bg.BsrFlashGat(adj, negative_slope=0.5, device="cpu")
    assert not torch.equal(a(d, s, h, 0), other(d, s, h, 0))
    with pytest.raises(NotImplementedError, match="packed"):
        a(d, s, h, 0, raw_out=True)
    with pytest.raises(NotImplementedError, match="packed"):
        JBsrFlashGat(adj, tile_i=128, tile_j=128)(
            d.numpy(), s.numpy(), h.numpy(), 0.0, raw_out=True)
    g = from_data(Data(**_arrays(10)), device="cpu")
    conv = GATConv(F_IN, 5, heads=2, raw_out=True)
    with pytest.raises(NotImplementedError):
        conv(g, g.x, flash_op=tcit.gat_flash_op(g, "bsr"))


def test_cpu_wrappers_compute_plain_and_count_no_launch():
    n, H, C = 50, 2, 3
    mask = bg.BlockMask(*np.nonzero(_mask(12, n)), n)
    d, s, h, g = [torch.from_numpy(a) for a in _node_inputs(12, n, H, C)]
    seed = torch.tensor([3], dtype=torch.int32)
    counters = (bg.bsr_gat_fwd, bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_col)
    before = [c.launches for c in counters]
    out, lse = bg.bsr_gat_fwd(mask, d, s, h, seed, 0.6)
    want = bg.bsr_gat_fwd_plain(mask, d, s, h, seed, 0.6)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    for a, b in zip(bg.bsr_gat_bwd(mask, d, s, h, lse, out, g, seed, 0.6),
                    bg.bsr_gat_bwd_plain(mask, d, s, h, lse, out, g, seed,
                                         0.6)):
        assert torch.equal(a, b)
    assert [c.launches for c in counters] == before


def test_wrappers_refuse_bad_inputs_and_other_devices():
    n = 20
    adj = torch.from_numpy(_mask(13, n))
    mask = bg.BlockMask(*np.nonzero(adj.numpy()), n)
    d, s, h = torch.zeros(n, 2), torch.zeros(n, 2), torch.zeros(n, 6)
    seed = torch.zeros(1, dtype=torch.int32)
    lse, out, g = torch.zeros(n, 2), torch.zeros(n, 6), torch.zeros(n, 6)
    with pytest.raises(TypeError, match="BlockMask"):
        bg.bsr_gat_fwd(fg.BitMask(adj), d, s, h, seed)
    with pytest.raises(TypeError, match="BitMask"):
        fg.flash_gat_fwd(mask, d, s, h, seed)
    with pytest.raises(ValueError):
        bg.bsr_gat_fwd(mask, d, s, torch.zeros(n, 5), seed)
    with pytest.raises(ValueError, match="rows"):
        bg.bsr_gat_fwd(mask, d[:10], s[:10], h[:10], seed)
    with pytest.raises(TypeError):
        bg.bsr_gat_fwd(mask, d, s, h, seed.long())
    with pytest.raises(TypeError):
        bg.bsr_gat_fwd(mask, d.double(), s, h, seed)
    with pytest.raises(ValueError, match="g must be"):
        bg.bsr_gat_bwd_row(mask, d, s, h, lse, out, torch.zeros(n, 8), seed)
    with pytest.raises(ValueError, match="D must be"):
        bg.bsr_gat_bwd_col(mask, d, s, h, lse, torch.zeros(n, 3), g, seed)
    meta = [t.to("meta") for t in (d, s, h, seed)]
    with pytest.raises(ValueError):
        bg.bsr_gat_fwd(mask, *meta)


# ---------------------------------------------------------------------------
# GATConv and the model on the bsr backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,concat", [(8, True), (1, False), (3, True)])
def test_gat_conv_through_the_bsr_operator_matches_jax_sparse(heads, concat):
    arrays = _arrays(14)
    g = from_data(Data(**arrays), device="cpu")
    jg = j_from_data(JData(**arrays))
    jconv = JGATConv(5, heads=heads, concat=concat)
    params = jconv.init(jax.random.PRNGKey(1), jg, jg.x)
    conv = GATConv(F_IN, 5, heads=heads, concat=concat)
    conv.load_state_dict(params_from_jax(params))
    got = conv(g, g.x, flash_op=tcit.gat_flash_op(g, "bsr"))
    # the fp32 sparse paths of both packages (no duplicate edges here)
    _close(got, jconv.apply(params, jg, jg.x), 1e-5)
    _close(got, conv(g, g.x).detach().numpy(), 1e-5)
    _close(got, conv(g, g.x, flash_op=tcit.gat_flash_op(g, "dense"))
           .detach().numpy(), 1e-5)


def test_params_from_jax_carries_the_pubmed_model():
    """examples/gat.py's PubMed model, 500 -> 8 x 8 -> 3, at its full
    widths on a small graph: the same names and layouts as on Cora."""
    from examples.gat import GAT as JGAT

    arrays = _arrays(15, n=40, e=120)
    arrays["x"] = np.random.default_rng(15).random((40, 500),
                                                   dtype=np.float32)
    arrays["y"] = arrays["y"] % 3
    g = from_data(Data(**arrays), device="cpu")
    jg = j_from_data(JData(**arrays))
    jmodel = JGAT(num_classes=3)
    key = jax.random.PRNGKey(0)
    params = jmodel.init({"params": key, "dropout": key}, jg, jg.x)
    state = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        "conv1.weight": (500, 64), "conv1.att_src": (1, 8, 8),
        "conv1.att_dst": (1, 8, 8), "conv1.bias": (64,),
        "conv2.weight": (64, 3), "conv2.att_src": (1, 1, 3),
        "conv2.att_dst": (1, 1, 3), "conv2.bias": (3,)}
    model = tcit.GAT(500, 3)
    model.load_state_dict(state)
    got = model(g, g.x, flash_op=tcit.gat_flash_op(g, "bsr"))
    _close(got, jmodel.apply(params, jg, jg.x), 1e-5)


def test_gat_flash_op_bsr_backend():
    g = from_data(Data(**_arrays(18)), device="cpu")
    op = tcit.gat_flash_op(g, "bsr")
    assert isinstance(op, bg.BsrFlashGat)
    assert op.device == g.device and op.n == g.num_nodes
    senders, receivers = gat_edge_set(g)
    rows, cols = op.mask.entries()
    np.testing.assert_array_equal(rows.numpy(), receivers)
    np.testing.assert_array_equal(cols.numpy(), senders)
    dense = gat_dense_adj(g)
    assert op.mask.num_entries == int(dense.sum())
    with pytest.raises(ValueError, match="'bsr'"):
        tcit.gat_flash_op(g, "none")


def test_five_adamw_steps_bsr_backend_match_packed_backend():
    """``create_gat_train_step`` with the block-sparse operator against
    the packed one (itself held to the JAX example's steps in
    tests/test_torch_port_gat.py), dropout off; no launch is counted."""
    g = from_data(Data(**_arrays(19)), device="cpu")
    counters = (bg.bsr_gat_fwd, bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_col)
    before = [c.launches for c in counters]
    models, steps = [], []
    for backend in ("packed", "bsr"):
        model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0,
                         generator=torch.Generator().manual_seed(2))
        models.append(model)
        steps.append(tcit.create_gat_train_step(model, g, backend=backend))
    for _ in range(5):
        want, got = (step()["loss"] for step, _ in steps)
        _close(got, want.numpy(), 1e-4)
    for p, q in zip(models[1].state_dict().values(),
                    models[0].state_dict().values()):
        _close(p, q.numpy(), 1e-4)
    assert [c.launches for c in counters] == before


def test_a_reordered_graph_trains_to_the_same_loss_curve():
    """RCM relabels the nodes and changes no result: five AdamW steps,
    dropout off, on the reordered and the unreordered graph."""
    arrays = _arrays(20)
    graphs = [from_data(Data(**arrays), device="cpu"),
              from_data(reorder.reorder_graph(Data(**arrays)), device="cpu")]
    assert not torch.equal(graphs[0].x, graphs[1].x)
    curves = []
    for g in graphs:
        model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0,
                         generator=torch.Generator().manual_seed(3))
        step, evaluate = tcit.create_gat_train_step(model, g, backend="bsr")
        curves.append(([float(step()["loss"]) for _ in range(5)],
                       evaluate()))
    np.testing.assert_allclose(curves[1][0], curves[0][0], rtol=1e-4)
    assert curves[0][0][-1] < curves[0][0][0]
    for split in ("train", "val", "test"):
        assert abs(float(curves[1][1][f"{split}_acc"])
                   - float(curves[0][1][f"{split}_acc"])) <= 0.02, split


def test_attention_dropout_on_the_bsr_backend_follows_the_generator():
    g = from_data(Data(**_arrays(21)), device="cpu")
    op = tcit.gat_flash_op(g, "bsr")
    model = tcit.GAT(F_IN, CLASSES, generator=torch.Generator().manual_seed(0))

    def run(seed):
        return model(g, g.x, train=True, flash_op=op,
                     generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_gat_bsr_backend_cpu_trains_and_counts_no_launch():
    g = from_data(reorder.reorder_graph(Data(**_arrays(22, n=300, e=1000))),
                  device="cpu")
    counters = (bg.bsr_gat_fwd, bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_col,
                fg.flash_gat_fwd, fg.flash_gat_bwd, pg.packed_gat_fwd,
                pg.packed_gat_bwd)
    before = [c.launches for c in counters]
    model, metrics = tcit.train_gat(g, num_classes=CLASSES, epochs=5,
                                    device="cpu", backend="bsr")
    loss = metrics["curve"]["loss"]
    assert loss.shape == (5,) and np.isfinite(loss).all()
    assert all(0.0 <= metrics[f"{k}_acc"] <= 1.0
               for k in ("train", "val", "test"))
    assert isinstance(model, tcit.GAT)
    # the same seed draws the same dropout: the run repeats bit for bit
    again, repeat = tcit.train_gat(g, num_classes=CLASSES, epochs=5,
                                   device="cpu", backend="bsr")
    np.testing.assert_array_equal(repeat["curve"]["loss"], loss)
    fresh = tcit.GAT(F_IN, CLASSES, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(model.conv1.weight, fresh.conv1.weight)
    assert torch.equal(model.conv1.weight, again.conv1.weight)
    assert [c.launches for c in counters] == before
