"""Port parity, the message-passing core: ``propagate`` for every ``aggr``,
with and without a ``message_fn``, through its plain path and through
the graph's operators (``propagate_operators``: the kernels' plain
versions on the CPU), forward and gradients against the JAX package;
``edge_gather`` / ``sddmm``; the utils ``softmax``, ``repeat``,
``to_undirected`` / ``is_undirected``; the geometric transforms. Inputs
are small padded graphs drawn from a numpy seed and collated by each
package's own ``from_data``. Tolerances: fp32 1e-5 relative to the
largest reference magnitude, gradients 1e-4; the numpy utils and
transforms exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.nn.message_passing import propagate as j_propagate
from pytorch_geometric_tpu.ops.sddmm import edge_gather as j_edge_gather
from pytorch_geometric_tpu.ops.sddmm import sddmm as j_sddmm
from pytorch_geometric_tpu.ops.spmm import SpmmOperator as JSpmmOperator
from pytorch_geometric_tpu.transforms import geometry as jgeo
from pytorch_geometric_tpu.utils import undirected as jund
from pytorch_geometric_tpu.utils.repeat import repeat as j_repeat
from pytorch_geometric_tpu.utils.softmax import softmax as j_softmax
from pytorch_geometric_tpu_torch import debug
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.nn.message_passing import (
    AGGRS, propagate, propagate_operators)
from pytorch_geometric_tpu_torch.ops.sddmm import edge_gather, sddmm
from pytorch_geometric_tpu_torch.transforms import geometry as tgeo
from pytorch_geometric_tpu_torch.utils import repeat, softmax
from pytorch_geometric_tpu_torch.utils import undirected as tund

F = 8


def _arrays(seed, n=40, e=160, fe=2):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return dict(x=rng.normal(size=(n, F)).astype(np.float32), edge_index=ei,
                edge_attr=rng.normal(size=(e, fe)).astype(np.float32))


def _graphs(seed=0, **kw):
    arrays = _arrays(seed, **kw)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _t_message(x_j, x_i, ea):
    return x_j * torch.tanh(x_i) + ea[:, :1]


def _j_message(x_j, x_i, ea):
    return x_j * jnp.tanh(x_i) + ea[:, :1]


def _edge_weight(g, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, g.num_edges).astype(np.float32)


@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("message", [False, True])
@pytest.mark.parametrize("operators", [False, True])
def test_propagate_matches_jax(aggr, message, operators):
    """Output, dx and d(edge_weight) of a weighted round against the JAX
    slow path (the same function as its SpMM fast path)."""
    g, jg = _graphs(1)
    ew = _edge_weight(g, 2)
    ct = np.random.default_rng(3).normal(
        size=(g.num_nodes, F)).astype(np.float32)

    def jloss(x, w):
        out = j_propagate(jg, x, _j_message if message else None, aggr,
                          edge_weight=w)
        return jnp.sum(out * ct), out

    (_, want), (jdx, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jg.x, jnp.asarray(ew))
    x = g.x.clone().requires_grad_(True)
    w = torch.from_numpy(ew).requires_grad_(True)
    ops = propagate_operators(g) if operators else {}
    out = propagate(g, x, _t_message if message else None, aggr,
                    edge_weight=w, **ops)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, want, 1e-5)
    _close(x.grad, jdx, 1e-4)
    _close(w.grad, jdw, 1e-4)


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_propagate_spmm_path_without_weights_matches_jax_fast_path(aggr):
    """The identity message with no ``edge_weight``: ``add`` through the
    operator equals the JAX package's SpMM fast path (padding edges weigh
    0), ``mean`` its masked mean."""
    g, jg = _graphs(4)
    jop = JSpmmOperator(np.asarray(jg.senders), np.asarray(jg.receivers),
                        jg.num_nodes, window=64, tile=128)
    want = j_propagate(jg, jg.x, aggr=aggr,
                       spmm_op=jop if aggr == "add" else None)
    got = propagate(g, g.x, aggr=aggr, **propagate_operators(g))
    _close(got, want, 1e-5)


def test_propagate_x_dst_feeds_the_receivers_side():
    g, jg = _graphs(5)
    x_dst = np.random.default_rng(6).normal(
        size=(g.num_nodes, F)).astype(np.float32)
    want = j_propagate(jg, jg.x, _j_message, "add", x_dst=jnp.asarray(x_dst))
    got = propagate(g, g.x, _t_message, "add", x_dst=torch.from_numpy(x_dst),
                    **propagate_operators(g))
    _close(got, want, 1e-5)


def test_propagate_operators_run_the_kernels_wrappers(monkeypatch):
    """Through the operators the sums go through ``spmm_csr`` (identity
    message) and ``sorted_segment_sum`` (a message_fn), whose CPU path is
    their plain version; ``max`` needs neither."""
    from pytorch_geometric_tpu_torch.ops import sorted_spmm, spmm

    g, _ = _graphs(7)
    ops = propagate_operators(g)
    calls = []
    for mod, name in ((spmm, "spmm_csr_plain"),
                      (sorted_spmm, "sorted_segment_sum_plain")):
        def spy(*a, _orig=getattr(mod, name), _name=name):
            calls.append(_name)
            return _orig(*a)
        monkeypatch.setattr(mod, name, spy)
    propagate(g, g.x, aggr="add", **ops)
    propagate(g, g.x, _t_message, aggr="mean", **ops)
    propagate(g, g.x, _t_message, aggr="max", **ops)
    assert calls == ["spmm_csr_plain", "sorted_segment_sum_plain"]


@pytest.mark.parametrize("message", [False, True])
@pytest.mark.parametrize("aggr", ["add", "sum", "mean"])
def test_propagate_off_the_cpu_raises_without_its_operator(message, aggr):
    """A sum or mean of feature rows off the CPU needs its operator: no
    plain segment op runs there (a meta tensor stands for the card)."""
    g, _ = _graphs(8)
    x = torch.empty(g.num_nodes, F, device="meta")
    with pytest.raises(ValueError, match="needs"):
        propagate(g, x, _t_message if message else None, aggr)
    if message:   # the SpMM cannot take messages
        with pytest.raises(ValueError, match="segment_op"):
            propagate(g, x, _t_message, aggr,
                      spmm_op=propagate_operators(g)["spmm_op"])


def test_propagate_debug_mode_checks_the_edges():
    g, _ = _graphs(9)
    bad = g.replace(senders=g.senders.clone().fill_(g.num_nodes))
    propagate(bad.replace(senders=g.senders), g.x)
    with debug.debug():
        with pytest.raises(ValueError, match="out of range"):
            propagate(bad, g.x)
        with pytest.raises(ValueError, match="rows"):
            propagate(g, g.x[:-1])
    with pytest.raises(ValueError, match="aggr must be"):
        propagate(g, g.x, aggr="prod")


def test_edge_gather_and_sddmm_match_jax():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(30, 3, 5)).astype(np.float32)
    b = rng.normal(size=(30, 3, 5)).astype(np.float32)
    s, r = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
    ts, tr = torch.from_numpy(s), torch.from_numpy(r)
    np.testing.assert_array_equal(_np(edge_gather(torch.from_numpy(a), ts)),
                                  np.asarray(j_edge_gather(a, s)))
    _close(sddmm(ts, tr, torch.from_numpy(a), torch.from_numpy(b)),
           j_sddmm(s, r, a, b), 1e-5)
    _close(sddmm(ts, tr, torch.from_numpy(a[:, 0])),
           j_sddmm(s, r, a[:, 0]), 1e-5)


def test_softmax_util_matches_jax():
    g, jg = _graphs(11)
    logits = np.random.default_rng(12).normal(
        size=(g.num_edges, 2)).astype(np.float32)
    want = j_softmax(logits, jg.receivers, jg.num_nodes,
                             mask=jg.edge_mask)
    got = softmax(torch.from_numpy(logits), g.receivers, g.num_nodes,
                  mask=g.edge_mask)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("src", [None, 3, 2.5, [1, 2], [1, 2, 3, 4, 5],
                                 (4, 5, 6)])
def test_repeat_matches_jax(src):
    assert repeat(src, 3) == j_repeat(src, 3)


@pytest.mark.parametrize("num_nodes", [None, 60])
def test_to_undirected_and_is_undirected_match_jax(num_nodes):
    rng = np.random.default_rng(13)
    s, r = rng.integers(0, 50, 120), rng.integers(0, 50, 120)
    got, want = tund.to_undirected(s, r, num_nodes), \
        jund.to_undirected(s, r, num_nodes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tund.is_undirected(*got, num_nodes)
    assert tund.is_undirected(s, r, num_nodes) == \
        jund.is_undirected(s, r, num_nodes) is False


def _points(seed, with_attr):
    rng = np.random.default_rng(seed)
    n, e = 25, 70
    kw = dict(pos=rng.normal(size=(n, 2)).astype(np.float32),
              edge_index=np.stack([rng.integers(0, n, e),
                                   rng.integers(0, n, e)]))
    if with_attr:
        kw["edge_attr"] = rng.normal(size=(e, 3)).astype(np.float32)
    return kw


@pytest.mark.parametrize("name", ["Cartesian", "Distance", "Polar",
                                  "TargetIndegree"])
@pytest.mark.parametrize("kw", [{}, {"norm": False}, {"cat": False},
                                {"max_value": 3.0}])
@pytest.mark.parametrize("with_attr", [False, True])
def test_geometry_transforms_match_jax(name, kw, with_attr):
    got = getattr(tgeo, name)(**kw)(Data(**_points(14, with_attr)))
    want = getattr(jgeo, name)(**kw)(JData(**_points(14, with_attr)))
    np.testing.assert_array_equal(got.edge_attr, want.edge_attr)
    assert got.edge_attr.dtype == np.float32


@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_segment_sum_gather_is_its_transpose(shape):
    """``SortedSegmentSum.gather`` is ``x[receivers]`` and its gradient is
    the operator's segment sum: the JAX ``jnp.take`` and its VJP."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum

    rng = np.random.default_rng(20)
    n, e = 30, 100
    ids = rng.integers(0, n - 3, e)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    ct = rng.normal(size=(e,) + shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jnp.take(v, jnp.asarray(ids), axis=0),
                        jnp.asarray(x))
    op = SortedSegmentSum(ids, n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    got = op.gather(xt)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    _close(xt.grad, vjp(jnp.asarray(ct))[0], 1e-5)
    _close(op(torch.from_numpy(ct)), vjp(jnp.asarray(ct))[0], 1e-5)
