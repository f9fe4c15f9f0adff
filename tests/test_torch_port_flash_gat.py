"""Port parity, dense-mask GAT slice: the coordinate hash, the packed
mask, ``gat_dense_adj``, ``FlashGatOperator`` (its kernels' plain versions
on the CPU), ``GATConv(adj=)`` and the ``GAT`` trained with
``backend="dense"``, against the JAX package run as its own tests run it
on the CPU (Pallas interpret mode).

Tolerances, relative to the largest reference magnitude:

- bit for bit: the hash, the masks;
- 2e-2 against the JAX ``FlashGatOperator`` and the JAX ``GATConv(adj=)``,
  which round their products (and the whole dense chain) to bf16; the
  JAX operator's gradients by relative L2 norm within 5e-2, as
  ``tests/test_torch_port_gat.py`` gates the packed operator's;
- 1e-5 against fp32 references of the forward (the port's sparse
  ``GATConv`` path, ``PackedFlashGat`` without dropout, a dense softmax
  written here); 1e-4 for gradients against autograd through that dense
  softmax, and for five AdamW steps against ``backend="packed"``.

Dropout is compared with it on wherever both sides hash it from the
same (seed, row, column, head); it is off where flax and torch would
draw different masks, and against ``PackedFlashGat``, which hashes the
edge id instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv import gat_dense_adj as j_gat_dense_adj
from pytorch_geometric_tpu.ops.flash_gat import (
    FlashGatOperator as JFlashGatOperator)
from pytorch_geometric_tpu.ops.flash_gat import _hash_keep_bits
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.nn.conv import (
    GATConv, gat_dense_adj, gat_edge_set)
from pytorch_geometric_tpu_torch.ops import flash_gat as fg
from pytorch_geometric_tpu_torch.ops import packed_gat as pg

F_IN, CLASSES = 12, 4
SLOPE = 0.2


def _arrays(seed=0, n=90, e=300):
    """A graph without duplicate edges, with pre-existing self loops (at
    nodes 0-5) and, once padded, padding nodes and edges."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    loops = np.tile(np.arange(6), (2, 1))
    ei = np.unique(np.concatenate([ei, loops], axis=1), axis=1)
    return dict(x=rng.normal(size=(n, F_IN)).astype(np.float32),
                edge_index=ei,
                y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.4, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


def _graphs(seed=0, **kw):
    arrays = _arrays(seed, **kw)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _mask(seed, n, density=0.1, empty=()):
    """A directed (asymmetric) boolean mask with a full diagonal, apart
    from the rows in ``empty``, which hold no entry."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < density) | np.eye(n, dtype=bool)
    adj[list(empty), :] = False
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


def _dense_softmax(adj, d, s, h, seed, rate):
    """A straightforward dense GAT layer in torch, head by head: masked
    softmax, dropout of the normalised weights by the port's hash, one
    product. The reference that autograd differentiates."""
    n, H = d.shape
    C = h.shape[1] // H
    idx = torch.arange(n)
    outs = []
    for hd in range(H):
        z = torch.nn.functional.leaky_relu(d[:, hd, None] + s[None, :, hd],
                                           SLOPE)
        alpha = torch.softmax(torch.where(adj, z, -1e30), dim=1) * adj
        if rate:
            bits = fg.hash_keep_bits(torch.tensor(seed), idx[:, None],
                                     idx[None], hd)
            alpha = torch.where(bits >= pg.dropout_threshold(rate),
                                alpha / (1.0 - rate), 0.0)
        outs.append(alpha @ h[:, hd * C:(hd + 1) * C])
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# host side: hash, packed mask, dense adjacency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 2 ** 20 - 1])
@pytest.mark.parametrize("row0", [0, 128, 8064])
def test_hash_keep_bits_match_jax_bitwise(seed, row0):
    shape = (64, 300)
    rows = torch.arange(row0, row0 + shape[0])[:, None]
    cols = torch.arange(shape[1])[None]
    for hd in (0, 3, 7):
        want = np.asarray(_hash_keep_bits(jnp.asarray(seed, jnp.int32), row0,
                                          hd, shape)).astype(np.int64)
        got = fg.hash_keep_bits(torch.tensor(seed), rows, cols, hd)
        np.testing.assert_array_equal(got.numpy(), want)


def test_hash_is_not_symmetric_in_row_and_column():
    idx = torch.arange(50)
    bits = fg.hash_keep_bits(torch.tensor(3), idx[:, None], idx[None], 1)
    assert not torch.equal(bits, bits.t())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 37, 96, 200])
def test_bit_mask_round_trip_and_transpose(n):
    adj = torch.from_numpy(_mask(n, n, 0.2) if n > 1
                           else np.ones((1, 1), dtype=bool))
    mask = fg.BitMask(adj)
    words = (n + 31) // 32
    assert mask.bits.shape == mask.bits_t.shape == (n, words)
    assert mask.bits.dtype == torch.int32 and mask.words == words
    assert torch.equal(mask.dense(), adj)
    assert torch.equal(fg.unpack_mask(mask.bits_t, n), adj.t())
    # column 32 w + b sits in bit b of word w; no bit past column n is set
    i, j = 0, n - 1
    assert bool((mask.bits[i, j // 32] >> (j % 32)) & 1) == bool(adj[i, j])
    full = fg.unpack_mask(mask.bits, words * 32)
    assert not full[:, n:].any()


def test_bit_mask_refuses_other_inputs():
    with pytest.raises(ValueError, match="square bool"):
        fg.BitMask(torch.ones(3, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="square bool"):
        fg.BitMask(torch.ones(3, 3))


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gat_dense_adj_matches_jax_and_the_edge_set(add_self_loops):
    g, jg = _graphs(1)
    assert g.num_nodes > 90 and not bool(g.edge_mask.all())   # padded
    adj = gat_dense_adj(g, add_self_loops)
    assert adj.dtype == torch.bool and adj.device == g.device
    want = np.asarray(j_gat_dense_adj(jg, add_self_loops))
    np.testing.assert_array_equal(adj.numpy(), want)
    if add_self_loops:
        senders, receivers = gat_edge_set(g)
        scatter = np.zeros_like(want)
        scatter[receivers, senders] = True
        np.testing.assert_array_equal(adj.numpy(), scatter)


# ---------------------------------------------------------------------------
# the operator against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("n,H,C", [(37, 8, 8), (96, 1, 7), (200, 3, 5)])
def test_flash_gat_operator_matches_jax_operator(n, H, C, rate):
    """Forward and grads of d, s and h on an asymmetric mask with the same
    dropout seed: the same (row, column, head) entries are dropped."""
    adj = _mask(n + H, n)
    d, s, h, proj = _node_inputs(n + C, n, H, C)
    seed = 11
    jop = JFlashGatOperator(adj)

    def loss(d, s, h):
        return jnp.sum(jop(d, s, h, float(seed), rate=rate) * proj)

    want = jop(d, s, h, float(seed), rate=rate)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(d, s, h)
    op = fg.FlashGatOperator(adj, device="cpu")
    got, grads = _port_vjp(op, d, s, h, proj, seed, rate)
    _close(got, want, 2e-2)
    for a, b in zip(grads, want_grads):
        # the JAX kernel rounds p, h, g and beta to bf16; disagreeing
        # dropout bits would move these by O(1)
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 5e-2 * np.linalg.norm(b)


@pytest.mark.parametrize("H,C", [(8, 8), (1, 7), (3, 5)])
def test_flash_gat_operator_matches_packed_operator_without_dropout(H, C):
    """Without dropout the two fused operators compute one function:
    output and gradients."""
    g, _ = _graphs(2)
    n = g.num_nodes
    d, s, h, proj = _node_inputs(3, n, H, C)
    dense = fg.FlashGatOperator(gat_dense_adj(g), device="cpu")
    senders, receivers = gat_edge_set(g)
    packed = pg.PackedFlashGat(senders=senders, receivers=receivers,
                               num_nodes=n, device="cpu")
    got, grads = _port_vjp(dense, d, s, h, proj, 0, 0.0)
    ts = [torch.from_numpy(a).requires_grad_() for a in (d, s, h)]
    want = packed(*ts, 0, rate=0.0)
    (want * torch.from_numpy(proj)).sum().backward()
    _close(got, want.detach().numpy(), 1e-5)
    for a, t in zip(grads, ts):
        _close(a, t.grad.numpy(), 1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("n,H,C", [(37, 8, 8), (96, 1, 7), (200, 3, 5)])
def test_plain_versions_match_autograd_through_a_dense_softmax(n, H, C,
                                                               rate):
    """``flash_gat_fwd_plain`` and ``flash_gat_bwd_plain`` (the kernels'
    references; the backward rebuilds alpha from the saved lse and uses
    D = <g, out>) against a dense softmax and its autograd gradients, on
    an asymmetric mask, dropout on and off with the same bits."""
    adj = torch.from_numpy(_mask(n, n, 0.15))
    d, s, h, g = [torch.from_numpy(a) for a in _node_inputs(n + 1, n, H, C)]
    seed = torch.tensor([77], dtype=torch.int32)
    out, lse = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    ins = [t.clone().requires_grad_() for t in (d, s, h)]
    want = _dense_softmax(adj, *ins, 77, rate)
    (want * g).sum().backward()
    _close(out, want.detach().numpy(), 1e-5)
    grads = fg.flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, rate)
    for a, t in zip(grads, ins):
        _close(a, t.grad.numpy(), 1e-4)
    # lse is the log of the masked row sum of exp(z)
    z = torch.nn.functional.leaky_relu(d[:, None, :] + s[None, :, :], SLOPE)
    ref = torch.logsumexp(torch.where(adj[:, :, None], z, -torch.inf), dim=1)
    _close(lse, ref.numpy(), 1e-5)
    if rate:   # about 60% of the entries dropped, the row sums untouched
        full, full_lse = fg.flash_gat_fwd_plain(adj, d, s, h, seed, 0.0)
        assert not torch.allclose(out, full)
        assert torch.equal(lse, full_lse)


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_empty_rows_give_zeros_and_no_gradient(rate):
    n, H, C = 70, 3, 5
    empty = (4, 33, 69)
    adj = _mask(8, n, 0.1, empty=empty)
    d, s, h, proj = _node_inputs(9, n, H, C)
    op = fg.FlashGatOperator(adj, device="cpu")
    out, (dd, ds, dh) = _port_vjp(op, d, s, h, proj, 5, rate)
    assert torch.isfinite(out).all()
    assert (out[list(empty)] == 0).all() and (dd[list(empty)] == 0).all()
    assert all(torch.isfinite(t).all() for t in (dd, ds, dh))
    rest = [i for i in range(n) if i not in empty]
    assert (out[rest].abs().sum(dim=1) > 0).all()
    # node 4 receives from no one and so has no say in d, but it still
    # sends: column 4 of the mask is not empty
    assert adj[:, 4].any() and float(dh[4].abs().sum()) > 0
    # a sender no row lists gets no gradient
    adj[:, 12] = False
    _, (_, ds, dh) = _port_vjp(fg.FlashGatOperator(adj, device="cpu"), d, s,
                               h, proj, 5, rate)
    assert (ds[12] == 0).all() and (dh[12] == 0).all()


def test_operator_takes_numpy_and_tensor_masks_and_seeds():
    n, H, C = 40, 2, 3
    adj = _mask(10, n)
    d, s, h, _ = [torch.from_numpy(a) for a in _node_inputs(10, n, H, C)]
    a = fg.FlashGatOperator(adj, device="cpu")
    b = fg.FlashGatOperator(torch.from_numpy(adj), negative_slope=0.2,
                            device="cpu")
    seed = torch.tensor([9], dtype=torch.int64)
    assert torch.equal(a(d, s, h, 9, rate=0.5), b(d, s, h, seed, rate=0.5))
    assert not torch.equal(a(d, s, h, 9, rate=0.5), a(d, s, h, 10, rate=0.5))
    assert a.n == n and a.device == torch.device("cpu")
    other = fg.FlashGatOperator(adj, negative_slope=0.5, device="cpu")
    assert not torch.equal(a(d, s, h, 0), other(d, s, h, 0))


def test_raw_out_raises_as_in_the_jax_operator():
    adj = _mask(11, 20)
    d, s, h, _ = [torch.from_numpy(a) for a in _node_inputs(11, 20, 2, 3)]
    with pytest.raises(NotImplementedError, match="packed"):
        fg.FlashGatOperator(adj, device="cpu")(d, s, h, 0, raw_out=True)
    with pytest.raises(NotImplementedError, match="packed"):
        JFlashGatOperator(adj)(d.numpy(), s.numpy(), h.numpy(), 0.0,
                               raw_out=True)
    g, _ = _graphs(11)
    conv = GATConv(F_IN, 5, heads=2, raw_out=True)
    with pytest.raises(ValueError, match="fused"):
        conv(g, g.x, adj=gat_dense_adj(g))
    with pytest.raises(ValueError, match="fused"):
        conv(g, g.x, adj=gat_dense_adj(g),
             flash_op=tcit.gat_flash_op(g, "packed"))
    with pytest.raises(NotImplementedError):
        conv(g, g.x, flash_op=tcit.gat_flash_op(g, "dense"))


def test_cpu_wrappers_compute_plain_and_count_no_launch():
    n, H, C = 50, 2, 3
    adj = torch.from_numpy(_mask(12, n))
    mask = fg.BitMask(adj)
    d, s, h, g = [torch.from_numpy(a) for a in _node_inputs(12, n, H, C)]
    seed = torch.tensor([3], dtype=torch.int32)
    fwd0, bwd0 = fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches
    out, lse = fg.flash_gat_fwd(mask, d, s, h, seed, 0.6)
    want = fg.flash_gat_fwd_plain(adj, d, s, h, seed, 0.6)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    for a, b in zip(
            fg.flash_gat_bwd(mask, d, s, h, lse, out, g, seed, 0.6),
            fg.flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, 0.6)):
        assert torch.equal(a, b)
    assert (fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches) == (
        fwd0, bwd0)


def test_wrappers_refuse_bad_inputs_and_other_devices():
    n = 20
    mask = fg.BitMask(torch.from_numpy(_mask(13, n)))
    d, s, h = torch.zeros(n, 2), torch.zeros(n, 2), torch.zeros(n, 6)
    seed = torch.zeros(1, dtype=torch.int32)
    lse, out, g = torch.zeros(n, 2), torch.zeros(n, 6), torch.zeros(n, 6)
    with pytest.raises(TypeError, match="BitMask"):
        fg.flash_gat_fwd(mask.dense(), d, s, h, seed)
    with pytest.raises(ValueError):
        fg.flash_gat_fwd(mask, d, s, torch.zeros(n, 5), seed)
    with pytest.raises(ValueError, match="rows"):
        fg.flash_gat_fwd(mask, d[:10], s[:10], h[:10], seed)
    with pytest.raises(TypeError):
        fg.flash_gat_fwd(mask, d, s, h, seed.long())
    with pytest.raises(TypeError):
        fg.flash_gat_fwd(mask, d.double(), s, h, seed)
    with pytest.raises(TypeError):
        fg.flash_gat_fwd(mask, d, s, h.t().contiguous().t(), seed)
    with pytest.raises(ValueError, match="g must be"):
        fg.flash_gat_bwd(mask, d, s, h, lse, out, torch.zeros(n, 8), seed)
    with pytest.raises(ValueError, match="lse must be"):
        fg.flash_gat_bwd(mask, d, s, h, torch.zeros(n, 3), out, g, seed)
    meta = [t.to("meta") for t in (d, s, h, seed)]
    with pytest.raises(ValueError):
        fg.flash_gat_fwd(mask, *meta)


# ---------------------------------------------------------------------------
# GATConv(adj=) and the model on the dense backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,concat", [(3, True), (2, False)])
def test_gat_conv_dense_adj_matches_jax_dense_and_sparse(heads, concat):
    g, jg = _graphs(14)
    jconv = JGATConv(5, heads=heads, concat=concat)
    params = jconv.init(jax.random.PRNGKey(1), jg, jg.x)
    conv = GATConv(F_IN, 5, heads=heads, concat=concat)
    conv.load_state_dict(params_from_jax(params))
    got = conv(g, g.x, adj=gat_dense_adj(g))
    # the JAX dense chain runs in bf16
    _close(got, jconv.apply(params, jg, jg.x, adj=j_gat_dense_adj(jg)), 2e-2)
    # the fp32 sparse paths of both packages (no duplicate edges here)
    _close(got, jconv.apply(params, jg, jg.x), 1e-5)
    _close(got, conv(g, g.x).detach().numpy(), 1e-5)


@pytest.mark.parametrize("heads,concat", [(8, True), (1, False), (3, True)])
def test_gat_conv_through_the_dense_operator_matches_the_other_paths(
        heads, concat):
    g, _ = _graphs(15)
    conv = GATConv(F_IN, 5, heads=heads, concat=concat,
                   generator=torch.Generator().manual_seed(0))
    got = conv(g, g.x, flash_op=tcit.gat_flash_op(g, "dense"))
    _close(got, conv(g, g.x).detach().numpy(), 1e-5)
    _close(got, conv(g, g.x, adj=gat_dense_adj(g)).detach().numpy(), 1e-5)
    _close(got, conv(g, g.x, flash_op=tcit.gat_flash_op(g, "packed"))
           .detach().numpy(), 1e-5)


def test_gat_conv_dense_adj_dropout_draws_from_the_callers_generator():
    g, _ = _graphs(16)
    conv = GATConv(F_IN, 5, heads=2, dropout=0.5)
    adj = gat_dense_adj(g)

    def run(seed):
        return conv(g, g.x, train=True, adj=adj,
                    generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(conv(g, g.x, adj=adj), conv(g, g.x, adj=adj))


def test_gat_model_passes_adj_through_both_layers():
    g, _ = _graphs(17)
    model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0,
                     generator=torch.Generator().manual_seed(1))
    want = model(g, g.x)
    _close(model(g, g.x, adj=gat_dense_adj(g)), want.detach().numpy(), 1e-5)
    _close(model(g, g.x, flash_op=tcit.gat_flash_op(g, "dense")),
           want.detach().numpy(), 1e-5)


def test_gat_flash_op_backends():
    g, _ = _graphs(18)
    assert isinstance(tcit.gat_flash_op(g), pg.PackedFlashGat)
    assert isinstance(tcit.gat_flash_op(g, "packed"), pg.PackedFlashGat)
    assert isinstance(tcit.gat_flash_op(g, "auto"), pg.PackedFlashGat)
    dense = tcit.gat_flash_op(g, "dense")
    assert isinstance(dense, fg.FlashGatOperator)
    assert dense.device == g.device and dense.n == g.num_nodes
    assert torch.equal(dense.mask.dense(), gat_dense_adj(g))
    for name in ("xla", "none", ""):
        with pytest.raises(ValueError, match="backend"):
            tcit.gat_flash_op(g, name)
    big = Graph(senders=torch.zeros(1, dtype=torch.int32),
                receivers=torch.zeros(1, dtype=torch.int32),
                x=torch.zeros(fg.MAX_NODES + 1, 1))
    with pytest.raises(ValueError, match="8192"):
        tcit.gat_flash_op(big, "dense")
    with pytest.raises(ValueError, match="backend"):
        tcit.train_gat(g, CLASSES, epochs=1, device="cpu", backend="plain")


def test_five_adamw_steps_dense_backend_match_packed_backend():
    """``create_gat_train_step`` with the dense operator against the
    packed one (itself held to the JAX example's steps in
    tests/test_torch_port_gat.py), dropout off."""
    g, _ = _graphs(19)
    models, steps = [], []
    for backend in ("packed", "dense"):
        model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0,
                         generator=torch.Generator().manual_seed(2))
        models.append(model)
        steps.append(tcit.create_gat_train_step(model, g, backend=backend))
    for _ in range(5):
        want, got = (step()["loss"] for step, _ in steps)
        _close(got, want.numpy(), 1e-4)
    for (name, p), q in zip(models[1].state_dict().items(),
                            models[0].state_dict().values()):
        _close(p, q.numpy(), 1e-4)
    want, got = (evaluate() for _, evaluate in steps)
    for split in ("train", "val", "test"):
        assert abs(float(got[f"{split}_acc"])
                   - float(want[f"{split}_acc"])) <= 0.02, split


def test_attention_dropout_on_the_dense_backend_follows_the_generator():
    g, _ = _graphs(20)
    op = tcit.gat_flash_op(g, "dense")
    model = tcit.GAT(F_IN, CLASSES, generator=torch.Generator().manual_seed(0))

    def run(seed):
        return model(g, g.x, train=True, flash_op=op,
                     generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_gat_dense_backend_cpu_trains_and_counts_no_launch():
    g, _ = _graphs(21, n=150, e=500)
    counters = (fg.flash_gat_fwd, fg.flash_gat_bwd, pg.packed_gat_fwd,
                pg.packed_gat_bwd)
    before = [c.launches for c in counters]
    model, metrics = tcit.train_gat(g, num_classes=CLASSES, epochs=5,
                                    device="cpu", backend="dense")
    loss = metrics["curve"]["loss"]
    assert loss.shape == (5,) and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
    assert all(0.0 <= metrics[f"{k}_acc"] <= 1.0
               for k in ("train", "val", "test"))
    assert isinstance(model, tcit.GAT)
    assert [c.launches for c in counters] == before
