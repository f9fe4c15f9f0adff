"""Port parity: ``SplineConv``'s rectangular operator and examples/faust.py.

- ``spline_operator``: the (N·K, N) accumulator as one rectangular SpMM
  (row ``receiver·K + kernel index``, column ``sender``), against the JAX
  ``SplineConv`` (its fused segment sum) and against the K square
  operators of ``spline_operators``, on a FAUST mesh collated by each
  package's ``DataLoader`` (padding edges included): outputs 1e-5 of the
  largest magnitude, the input's and every parameter's gradient 1e-4; at
  FAUST's configuration (dim 3, kernel size 5, K = 125) and at a closed
  degree-2 spline with mean aggregation.
- The example's ``Net`` against the JAX script's ``Net`` (loaded from
  ``examples/faust.py`` by path), from the same flax parameters
  (``convert.params_from_jax``), on ~50-vertex meshes, dropout off:
  logits 1e-5, gradients of the masked NLL 1e-4; three Adam steps
  against ``optax.adam``: each step's loss 1e-5, then the logits 1e-4
  and each parameter 1e-4 in relative L2.
- ``run`` on the CPU: one operator per distinct batch, no kernel launch.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import FAUST as JFAUST
from pytorch_geometric_tpu.nn.conv import SplineConv as JSplineConv
from pytorch_geometric_tpu.transforms import Cartesian as JCartesian
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import FaceToEdge as JFaceToEdge
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.datasets import FAUST
from pytorch_geometric_tpu_torch.examples import faust
from pytorch_geometric_tpu_torch.nn.conv import (
    SplineConv, spline_edge_sets, spline_operator, spline_operators)
from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr
from pytorch_geometric_tpu_torch.transforms import (
    Cartesian, Compose, FaceToEdge)

REPO = Path(__file__).resolve().parents[1]
NV = 50          # 5 rings of 10 vertices; padded to 64


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "reference_examples_faust", REPO / "examples" / "faust.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Each package's FAUST at ``NV`` vertices, the first 3 meshes (the
    JAX dataset under its own root)."""
    root = tmp_path_factory.mktemp("faust")
    port = FAUST(str(root / "port"), pre_transform=Compose(
        [FaceToEdge(), Cartesian()]), num_vertices=NV)[:3]
    ref = JFAUST(str(root / "jax"), pre_transform=JCompose(
        [JFaceToEdge(), JCartesian()]), num_vertices=NV)[:3]
    return port, ref


@pytest.fixture
def loaders(meshes):
    """Each package's train loader over ``meshes``, shuffled from one
    seed: the same batches in the same order while both are drawn from
    in step."""
    port, ref = meshes
    return (DataLoader(port, batch_size=1, shuffle=True, seed=0,
                       device="cpu"),
            JDataLoader(ref, batch_size=1, shuffle=True, seed=0))


# ---------------------------------------------------------------------------
# SplineConv's rectangular operator
# ---------------------------------------------------------------------------

CONFIGS = {"faust": dict(dim=3, kernel_size=5),
           "closed_degree2_mean": dict(dim=2, kernel_size=3,
                                       is_open_spline=False, degree=2,
                                       aggr="mean")}


@functools.lru_cache(maxsize=None)
def _jax_conv(config):
    """The JAX ``SplineConv`` of ``config``: jitted init, apply, and the
    gradients of ``sum(out * proj)`` in the parameters and x (compiled
    once for the three routes)."""
    conv = JSplineConv(6, **CONFIGS[config])

    def f(p, g, x, pseudo, proj):
        return jnp.sum(conv.apply(p, g, x, pseudo) * proj)

    return (jax.jit(conv.init), jax.jit(conv.apply),
            jax.jit(jax.grad(f, argnums=(0, 2))))


@pytest.mark.parametrize("route", ["spline_op", "spline_fns", "plain"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_spline_conv_operator_matches_jax(config, route, loaders):
    kw = CONFIGS[config]
    loader, jloader = loaders
    g, jg = next(iter(loader)), next(iter(jloader))
    dim = kw["dim"]
    pseudo = g.edge_attr[:, :dim]
    jpseudo = jg.edge_attr[:, :dim]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(g.num_nodes, 4)).astype(np.float32)
    proj = rng.normal(size=(g.num_nodes, 6)).astype(np.float32)
    init, apply, grad = _jax_conv(config)
    params = init(jax.random.PRNGKey(0), jg, x, jpseudo)
    conv = SplineConv(4, 6, **kw)
    conv.load_state_dict(params_from_jax(params))
    op_kw = {k: v for k, v in kw.items() if k != "aggr"}
    extra = {"spline_op": dict(spline_op=spline_operator(
                 g, pseudo=pseudo, **op_kw)),
             "spline_fns": dict(spline_fns=spline_operators(
                 g, pseudo=pseudo, **op_kw)),
             "plain": {}}[route]
    xt = torch.from_numpy(x).requires_grad_()
    before = spmm_csr.launches
    out = conv(g, xt, pseudo, **extra)
    (out * torch.from_numpy(proj)).sum().backward()
    assert spmm_csr.launches == before        # the CPU runs plain versions
    want = apply(params, jg, x, jpseudo)
    gp, gx = grad(params, jg, x, jpseudo, proj)
    _close(out, want, 1e-5)
    _close(xt.grad, gx, 1e-4)
    gp = params_from_jax(gp)
    for name, p in conv.named_parameters():
        _close(p.grad, gp[name].numpy(), 1e-4)


def test_spline_operator_is_one_rectangular_csr(loaders):
    """Row ``receiver·K + kernel index``, column ``sender``: each
    nonzero (edge, corner) entry of the K square operators once, the
    transpose for ``dx``, and a (N·K, F) output that reshapes to the K
    operators' concatenation."""
    g = next(iter(loaders[0]))
    K, n = 125, g.num_nodes
    op = spline_operator(g, 3, 5)
    geom, consts = op.args
    assert (geom.n_dst, geom.n_src) == (n * K, n)
    assert (geom.fwd.num_rows, geom.bwd.num_rows) == (n * K, n)
    sets = spline_edge_sets(g, 3, 5)
    assert geom.fwd.num_edges == geom.bwd.num_edges == sum(
        s.size for s, _, _ in sets) <= 8 * int(g.edge_mask.sum())
    squares = spline_operators(g, 3, 5)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(n, 3)).astype(np.float32))
    a = op(x)
    assert tuple(a.shape) == (n * K, 3)
    b = torch.cat([fn(x) for fn in squares], dim=1)
    _close(a.reshape(n, K * 3), b.numpy(), 1e-6)
    # rows of padding nodes and empty kernel cells hold nothing
    counts = np.diff(geom.fwd.row_ptr.numpy())
    assert counts.reshape(n, K)[~g.node_mask.numpy()].sum() == 0
    assert (counts == 0).mean() > 0.5


# ---------------------------------------------------------------------------
# examples/faust.py
# ---------------------------------------------------------------------------

def _jax_loss(model, params, graph):
    """The JAX script's loss, dropout off."""
    logp = jax.nn.log_softmax(model.apply(params, graph))
    y = graph.y.astype(jnp.int32)
    nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
    m = graph.node_mask.astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)


@pytest.fixture(scope="module")
def jax_net(meshes):
    """The JAX script's ``Net``, its parameters, and its jitted logits and
    loss-with-gradients (compiled once for the module's tests)."""
    model = _jax_example().Net(num_vertices=NV)
    key = jax.random.PRNGKey(3)
    jg = next(iter(JDataLoader(meshes[1], batch_size=1)))
    params = jax.jit(model.init)({"params": key, "dropout": key}, jg)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, graph: _jax_loss(model, p, graph)))
    return params, jax.jit(model.apply), value_and_grad


def _port_model(params):
    net = faust.Net(NV)
    net.load_state_dict(params_from_jax(params))
    return net


def test_faust_net_matches_the_jax_example(jax_net, loaders):
    params, apply, value_and_grad = jax_net
    net = _port_model(params)
    assert sorted(dict(net.named_parameters())) == sorted(
        params_from_jax(params))
    g, jg = next(iter(loaders[0])), next(iter(loaders[1]))
    logits = net(g, spline_op=faust.faust_spline_op(g))
    _close(logits, apply(params, jg), 1e-5)
    loss = faust.nll_loss(logits, g)
    loss.backward()
    want_loss, grads = value_and_grad(params, jg)
    _close(loss, want_loss, 1e-5)
    want = params_from_jax(grads)
    for name, p in net.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4)


def test_three_adam_steps_match_optax(jax_net, loaders):
    """Three steps of the example's ``train_step`` (Adam 1e-2, dropout
    off) against optax.adam over the batches of one shuffled epoch of
    each package's loader, one operator per batch."""
    params, apply, value_and_grad = jax_net
    net = _port_model(params)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    tx = optax.adam(1e-2)
    state = tx.init(params)

    @jax.jit
    def adam(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    loader, jloader = loaders
    ops = faust.OperatorCache(faust.faust_spline_op)
    batches = list(zip(loader.indexed(), jloader))
    assert len(batches) == 3
    for (idx, g), jg in batches:
        loss = faust.train_step(net, opt, g, ops(idx, g), train=False)
        want, grads = value_and_grad(params, jg)
        params, state = adam(grads, state, params)
        _close(loss, want, 1e-5)
    want = params_from_jax(params)
    for name, p in net.named_parameters():
        b = want[name].numpy()
        assert np.linalg.norm(p.detach().numpy() - b) \
            <= 1e-4 * np.linalg.norm(b), name
    (idx, g), jg = batches[0]
    with torch.no_grad():
        logits = net(g, spline_op=ops(idx, g))
    _close(logits, apply(params, jg), 1e-4)
    assert len(ops.ops) == 3 and ops.seconds > 0


def test_example_run_builds_one_operator_per_batch_and_launches_nothing(
        tmp_path):
    pre = Compose([FaceToEdge(), Cartesian()])
    train = FAUST(str(tmp_path), pre_transform=pre, num_vertices=NV)[:3]
    test = FAUST(str(tmp_path), train=False, pre_transform=pre,
                 num_vertices=NV)[:2]
    loaders = (DataLoader(train, batch_size=1, shuffle=True, device="cpu"),
               DataLoader(test, batch_size=1, device="cpu"))
    before = spmm_csr.launches
    out = faust.run(2, loaders=loaders, device="cpu")
    assert spmm_csr.launches == before
    assert out["operators"] == 3 + 2
    assert out["step_losses"].shape == (2, 3)
    assert np.isfinite(out["step_losses"]).all()
    assert 0.0 <= out["acc"] <= 1.0
