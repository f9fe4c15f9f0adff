"""Port parity, pooling: every function of ``nn/pool/`` and
``MaskedBatchNorm`` against the JAX package, on the same numpy inputs
collated by each package's ``collate`` and the same flax parameters
(``convert.params_from_jax``), forward and gradients:

- ``MaskedBatchNorm`` with and without a mask, train (batch moments, the
  running statistics after the step: flax's 0.9 / 0.1 and the biased
  variance) and eval;
- the global pools, through their plain path and through the batch's
  ``SortedSegmentSum`` (``pool_operator``), on the collated masks and on
  a mask of dropped nodes (``TopKPooling``'s), every row compared, the
  padding graph's too;
- ``topk_mask`` / ``TopKPooling`` with tied scores;
- ``Set2Set`` against flax's ``OptimizedLSTMCell``, both paths;
- ``dense_diff_pool`` with and without a mask;
- the host ``max_pool`` / ``avg_pool`` bitwise, ``graclus`` bitwise,
  ``max_pool_x`` and ``pool_graph_masked`` (plain and through
  ``cluster_operator``);
- on a meta tensor (the card's stand-in) every sum that lacks its
  operator raises, as ``propagate`` does.

Tolerances: fp32 1e-5 relative to the largest reference magnitude,
gradients 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data.batch import collate as j_collate
from pytorch_geometric_tpu.nn import pool as jpool
from pytorch_geometric_tpu.nn.norm import MaskedBatchNorm as JMaskedBatchNorm
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.nn import pool
from pytorch_geometric_tpu_torch.nn.norm import MaskedBatchNorm
from pytorch_geometric_tpu_torch.ops import sorted_spmm

F = 6


def _datas(seed, count=4, cls=Data):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 12))
        e = 3 * n
        out.append(cls(x=rng.normal(size=(n, F)).astype(np.float32),
                       pos=rng.normal(size=(n, 2)).astype(np.float32),
                       edge_index=np.stack([rng.integers(0, n, e),
                                            rng.integers(0, n, e)]),
                       y=np.int64(rng.integers(0, 2))))
    return out


def _batches(seed=0, count=4):
    """The same graphs collated by each package (padding nodes on the
    padding graph, the last id)."""
    return (collate(_datas(seed, count), device="cpu"),
            j_collate(_datas(seed, count, JData)))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_() if grad else t


# ---------------------------------------------------------------------------
# MaskedBatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_matches_jax(masked):
    g, jg = _batches(1)
    rng = np.random.default_rng(2)
    x = rng.normal(2.0, 3.0, size=(g.num_nodes, F)).astype(np.float32)
    proj = rng.normal(size=x.shape).astype(np.float32)
    mask = _np(g.node_mask) if masked else None
    jmod = JMaskedBatchNorm()
    variables = jmod.init(jax.random.PRNGKey(0), x, mask)
    params = {"params": {"scale": rng.normal(size=F).astype(np.float32),
                         "bias": rng.normal(size=F).astype(np.float32)},
              "batch_stats": {"mean": rng.normal(size=F).astype(np.float32),
                              "var": rng.uniform(0.5, 2, F).astype(
                                  np.float32)}}
    assert jax.tree_util.tree_structure(dict(variables)) == \
        jax.tree_util.tree_structure(params)

    def f(p, x):
        y, mut = jmod.apply({"params": p, "batch_stats":
                             params["batch_stats"]}, x, mask, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * proj), (y, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params["params"], x)
    mod = MaskedBatchNorm(F)
    mod.load_state_dict(params_from_jax(params))
    xt = _t(x, grad=True)
    out = mod(xt, g.node_mask if masked else None, train=True)
    (out * _t(proj)).sum().backward()
    _close(out, want, 1e-5)
    _close(xt.grad, gx, 1e-4)
    _close(mod.scale.grad, gp["scale"], 1e-4)
    _close(mod.bias.grad, gp["bias"], 1e-4)
    # the running statistics after the step: flax's update, biased var
    _close(mod.mean, mut["batch_stats"]["mean"], 1e-6)
    _close(mod.var, mut["batch_stats"]["var"], 1e-6)
    # eval: the running statistics
    want = jmod.apply({"params": params["params"], **mut}, x, mask)
    with torch.no_grad():
        _close(mod(xt, g.node_mask if masked else None), want, 1e-5)


# ---------------------------------------------------------------------------
# global pools
# ---------------------------------------------------------------------------

def _dropped(g, jg, seed):
    """Each package's batch with a random third of the real nodes out of
    the mask, as after ``TopKPooling``."""
    rng = np.random.default_rng(seed)
    keep = _np(g.node_mask) & (rng.random(g.num_nodes) > 0.33)
    return (g.replace(node_mask=torch.from_numpy(keep)),
            jg.replace(node_mask=jnp.asarray(keep)))


POOLS = {"add": (pool.global_add_pool, jpool.global_add_pool),
         "mean": (pool.global_mean_pool, jpool.global_mean_pool),
         "max": (pool.global_max_pool, jpool.global_max_pool)}


@pytest.mark.parametrize("mask", ["collated", "dropped"])
@pytest.mark.parametrize("name,route", [
    ("add", "plain"), ("add", "operator"), ("mean", "plain"),
    ("mean", "operator"), ("max", "plain")])   # the max takes no operator
def test_global_pools_match_jax_on_every_row(name, route, mask):
    g, jg = _batches(3)
    op = pool.pool_operator(g) if route == "operator" else None
    if mask == "dropped":
        g, jg = _dropped(g, jg, 4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(g.num_nodes, F)).astype(np.float32)
    if name == "max":
        x[::3] = 0.0                       # ties, as after a ReLU
    proj = rng.normal(size=(g.num_graphs, F)).astype(np.float32)
    fn, jfn = POOLS[name]
    want, jvjp = jax.vjp(lambda v: jfn(v, jg), x)
    (gx,) = jvjp(proj)
    xt = _t(x, grad=True)
    kw = {"segment_op": op} if op is not None else {}
    before = sorted_spmm.sorted_segment_sum.launches
    out = fn(xt, g, **kw)
    (out * _t(proj)).sum().backward()
    assert out.shape == (g.num_graphs, F)
    _close(out, want, 1e-5)
    _close(xt.grad, gx, 1e-4)
    assert sorted_spmm.sorted_segment_sum.launches == before


def test_pool_operator_is_one_segment_sum_over_the_batch(monkeypatch):
    """The operator's rows are the graphs, the padding graph's included,
    and the mean runs one call of it (the rows and their count
    together)."""
    g, _ = _batches(6)
    op = pool.pool_operator(g)
    assert op.num_nodes == g.num_graphs
    np.testing.assert_array_equal(_np(op.receivers), _np(g.batch))
    calls = []
    orig = sorted_spmm.sorted_segment_sum
    monkeypatch.setattr(sorted_spmm, "sorted_segment_sum",
                        lambda *a: calls.append(1) or orig(*a))
    x = torch.randn(g.num_nodes, F)
    pool.global_mean_pool(x, g, segment_op=op)
    pool.global_add_pool(x, g, segment_op=op)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# TopK
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_topk_mask_with_tied_scores_matches_jax(ratio):
    g, jg = _batches(7)
    rng = np.random.default_rng(8)
    score = rng.normal(size=g.num_nodes).astype(np.float32)
    score[rng.random(g.num_nodes) < 0.5] = 0.0       # many ties
    score[:4] = 1.5
    got = pool.topk_mask(torch.from_numpy(score), g, ratio)
    want = jpool.topk_mask(jnp.asarray(score), jg, ratio)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the budget: ceil(ratio * n) of each real graph
    batch, keep = _np(g.batch), _np(got)
    for i in range(g.num_graphs - 1):
        n = int((batch == i).sum())
        assert keep[batch == i].sum() == int(np.ceil(np.float32(ratio) *
                                                     np.float32(n)))
    assert not keep[~_np(g.node_mask)].any()


def test_topk_pooling_matches_jax():
    g, jg = _batches(9)
    rng = np.random.default_rng(10)
    x = np.maximum(rng.normal(size=(g.num_nodes, F)), 0).astype(np.float32)
    x[1::4] = 0.0                         # zero rows: tied scores
    proj = rng.normal(size=x.shape).astype(np.float32)
    jmod = jpool.TopKPooling(F, ratio=0.8)
    params = jmod.init(jax.random.PRNGKey(1), jg, x)

    def f(p, x):
        new, gated, score = jmod.apply(p, jg, x)
        return jnp.sum(gated * proj) + jnp.sum(score), (new, gated, score)

    (_, (jnew, jgated, jscore)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, x)
    mod = pool.TopKPooling(F, ratio=0.8)
    mod.load_state_dict(params_from_jax(params))
    xt = _t(x, grad=True)
    new, gated, score = mod(g, xt)
    ((gated * _t(proj)).sum() + score.sum()).backward()
    _close(gated, jgated, 1e-5)
    _close(score, jscore, 1e-5)
    np.testing.assert_array_equal(_np(new.node_mask),
                                  np.asarray(jnew.node_mask))
    np.testing.assert_array_equal(_np(new.edge_mask),
                                  np.asarray(jnew.edge_mask))
    assert torch.equal(new.senders, g.senders)
    _close(xt.grad, gx, 1e-4)
    _close(mod.weight.grad, gp["params"]["weight"], 1e-4)


@pytest.mark.parametrize("route", ["plain", "operator"])
def test_mean_and_max_after_topk_match_jax_with_the_padding_row(route):
    """The readouts of a pooled batch: every row, the padding graph's
    with its dropped nodes' sum and count included."""
    g, jg = _batches(11)
    op = pool.pool_operator(g) if route == "operator" else None
    rng = np.random.default_rng(12)
    x = rng.normal(size=(g.num_nodes, F)).astype(np.float32)
    jmod = jpool.TopKPooling(F, ratio=0.5)
    params = jmod.init(jax.random.PRNGKey(2), jg, x)

    def readout(p, x):
        new, gated, _ = jmod.apply(p, jg, x)
        # the pools see the gated rows, and here also the raw ones, so
        # the dropped nodes' own rows reach the padding row
        return jnp.concatenate([jpool.global_max_pool(gated, new),
                                jpool.global_mean_pool(gated, new),
                                jpool.global_mean_pool(x, new)], 1)

    want, jvjp = jax.vjp(readout, params, x)
    proj = rng.normal(size=want.shape).astype(np.float32)
    gp, gx = jvjp(proj)
    mod = pool.TopKPooling(F, ratio=0.5)
    mod.load_state_dict(params_from_jax(params))
    xt = _t(x, grad=True)
    new, gated, _ = mod(g, xt)
    kw = {"segment_op": op} if op is not None else {}
    out = torch.cat([pool.global_max_pool(gated, new),
                     pool.global_mean_pool(gated, new, **kw),
                     pool.global_mean_pool(xt, new, **kw)], 1)
    (out * _t(proj)).sum().backward()
    _close(out, want, 1e-5)
    assert float(np.abs(np.asarray(want)[-1]).max()) > 0   # padding row
    _close(xt.grad, gx, 1e-4)
    _close(mod.weight.grad, gp["params"]["weight"], 1e-4)


# ---------------------------------------------------------------------------
# Set2Set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "operator"])
def test_set2set_matches_flax_lstm(route):
    g, jg = _batches(13)
    op = pool.pool_operator(g) if route == "operator" else None
    rng = np.random.default_rng(14)
    x = rng.normal(size=(g.num_nodes, F)).astype(np.float32)
    jmod = jpool.Set2Set(F, processing_steps=3)
    params = jmod.init(jax.random.PRNGKey(3), x, jg)
    # non-zero hidden biases, so that their mapping is exercised
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape),
                                        a.dtype), params)
    want, jvjp = jax.vjp(lambda p, v: jmod.apply(p, v, jg), params, x)
    proj = rng.normal(size=want.shape).astype(np.float32)
    gp, gx = jvjp(proj)
    mod = pool.Set2Set(F, processing_steps=3)
    mod.load_state_dict(params_from_jax(params))
    xt = _t(x, grad=True)
    kw = {"segment_op": op} if op is not None else {}
    out = mod(xt, g, **kw)
    (out * _t(proj)).sum().backward()
    assert out.shape == (g.num_graphs, 2 * F)
    _close(out, want, 1e-5)
    _close(xt.grad, gx, 1e-4)
    want = params_from_jax(gp)
    for name, p in mod.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[name].numpy(), 1e-4)
    assert not mod.OptimizedLSTMCell_0.bias_ih.requires_grad
    assert not mod.OptimizedLSTMCell_0.bias_ih.any()


# ---------------------------------------------------------------------------
# DiffPool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_dense_diff_pool_matches_jax(masked):
    rng = np.random.default_rng(15)
    B, N, C = 3, 10, 4
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    adj = (rng.random((B, N, N)) < 0.3).astype(np.float32)
    s = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = (np.arange(N)[None] < np.array([[10], [7], [4]])) if masked \
        else None

    def f(x, adj, s):
        return jpool.dense_diff_pool(x, adj, s, mask)

    want, jvjp = jax.vjp(f, x, adj, s)
    projs = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    jgrads = jvjp(tuple(jnp.asarray(p) for p in projs))
    ts = [_t(a, grad=True) for a in (x, adj, s)]
    out = pool.dense_diff_pool(*ts, torch.from_numpy(mask) if masked
                               else None)
    sum((o * _t(p)).sum() for o, p in zip(out, projs)).backward()
    for o, w in zip(out, want):
        _close(o, w, 1e-5)
    for t, jg_ in zip(ts, jgrads):
        _close(t.grad, jg_, 1e-4)


# ---------------------------------------------------------------------------
# coarsening
# ---------------------------------------------------------------------------

def _cluster(g, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, g.num_nodes // 2, g.num_nodes)


@pytest.mark.parametrize("name", ["max_pool", "avg_pool"])
def test_host_pools_match_jax_bitwise(name):
    rng = np.random.default_rng(16)
    n, e = 30, 90
    arrays = dict(x=rng.normal(size=(n, F)).astype(np.float32),
                  pos=rng.normal(size=(n, 3)).astype(np.float32),
                  edge_index=np.stack([rng.integers(0, n, e),
                                       rng.integers(0, n, e)]),
                  edge_attr=rng.normal(size=(e, 2)).astype(np.float32),
                  y=np.int64(1))
    data, jdata = Data(**arrays), JData(**arrays)
    data.batch = jdata.batch = np.repeat(np.arange(3), 10)
    cluster = rng.integers(0, 12, n)
    got = getattr(pool, name)(cluster, data)
    want = getattr(jpool, name)(cluster, jdata)
    for key in ("x", "pos", "edge_index", "edge_attr", "batch", "y"):
        np.testing.assert_array_equal(getattr(got, key),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)
        assert getattr(got, key).dtype == np.asarray(getattr(want,
                                                             key)).dtype


def test_graclus_matches_jax_bitwise():
    rng = np.random.default_rng(17)
    s, r = rng.integers(0, 40, 160), rng.integers(0, 40, 160)
    w = rng.random(160)
    np.testing.assert_array_equal(pool.graclus(s, r, w, 40, seed=3),
                                  jpool.graclus(s, r, w, 40, seed=3))


def test_max_pool_x_matches_jax():
    g, jg = _batches(18)
    rng = np.random.default_rng(19)
    x = rng.normal(size=(g.num_nodes, F)).astype(np.float32)
    cluster = _cluster(g, 20)
    want = jpool.max_pool_x(jnp.asarray(cluster), x, jg.batch,
                            node_mask=jg.node_mask)
    got = pool.max_pool_x(cluster, torch.from_numpy(x), g.batch,
                          node_mask=g.node_mask)
    _close(got[0], want[0], 0)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("reduce", ["max", "mean", "add"])
@pytest.mark.parametrize("route", ["plain", "operator"])
def test_pool_graph_masked_matches_jax(reduce, route):
    g, jg = _batches(21)
    cluster = _cluster(g, 22)
    op = pool.cluster_operator(cluster, g) if route == "operator" else None
    x = g.x.clone().requires_grad_()
    kw = {"segment_op": op} if op is not None else {}
    got = pool.pool_graph_masked(cluster, g.replace(x=x), reduce, **kw)

    def f(xx):
        return jpool.pool_graph_masked(jnp.asarray(cluster),
                                       jg.replace(x=xx), reduce)

    want = f(jg.x)
    want_x = want.x
    _close(got.x, want_x, 1e-5)
    _close(got.pos, want.pos, 1e-5)
    for key in ("senders", "receivers", "batch", "node_mask", "edge_mask"):
        np.testing.assert_array_equal(_np(getattr(got, key)),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)
    proj = np.random.default_rng(23).normal(size=want_x.shape).astype(
        np.float32)
    _, jvjp = jax.vjp(lambda xx: f(xx).x, jg.x)
    (gx,) = jvjp(proj)
    (got.x * _t(proj)).sum().backward()
    _close(x.grad, gx, 1e-4)


# ---------------------------------------------------------------------------
# no plain sums on the card
# ---------------------------------------------------------------------------

def test_sums_without_their_operator_raise_off_the_cpu():
    """A meta tensor stands for the card: the sums and means of the
    pools, Set2Set's readout and the device coarsening need their
    ``SortedSegmentSum``, as ``propagate`` needs its operators."""
    g, _ = _batches(24)
    meta = g.to("meta")
    x = torch.empty((g.num_nodes, F), device="meta")
    for fn in (pool.global_add_pool, pool.global_mean_pool):
        with pytest.raises(ValueError, match="needs segment_op"):
            fn(x, meta)
    with pytest.raises(ValueError, match="needs segment_op"):
        pool.Set2Set(F, 2).to("meta")(x, meta)
    for reduce in ("mean", "add"):
        with pytest.raises(ValueError, match="needs segment_op"):
            pool.pool_graph_masked(np.zeros(g.num_nodes, np.int64),
                                   meta.replace(x=x, pos=None), reduce)
    # the max needs none
    assert pool.global_max_pool(x, meta).shape == (g.num_graphs, F)
