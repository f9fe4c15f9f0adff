"""The inductive examples' steps over static buffers: the port's
counterpart of the JAX scripts' one jitted step a loader budget
(examples/ppi.py, examples/mutag_gin.py), which a card captures once in a
CUDA graph and replays for every batch (``models/capture.py``).

On the CPU, through the kernels' plain versions:

- each static operator (``StaticSpmmOperator``, ``StaticSegmentSum``,
  ``StaticPackedFlashGat``), loaded with two batches of different real
  sizes in turn into the same buffers, gives bitwise the forward and the
  gradients of a freshly built operator, with its spare slots filled with
  out-of-range columns (so nothing reads them);
- the MUTAG operator over the real entries (``SpmmOperator(edge_mask=)``,
  what ``mutag_operators`` builds) is bitwise the operator with the
  padding edges, on every row, forward and ``dx``;
- one SGD step of each example over its static buffers against the JAX
  script's model and loss on the same numpy-seeded collated batch, from
  the same flax parameters (``convert.params_from_jax``): the loss within
  1e-5, the parameters after the step within 1e-5 of the largest
  parameter magnitude (SGD: Adam turns a gradient that is rounding only,
  such as a bias before a batch norm, into a whole step);
- each example's run through its static buffers, with the capture left
  out (``CapturedStep(capture=False)``), bitwise the eager run: every
  step's loss, the metric and the final parameters;
- ``run(capture=True)`` on the CPU raises, and so does a static batch of
  a loader with ``dynamic_buckets``.

The card's checks of the captured steps (captured against eager within
1e-6, the launches by stage) are ``chip_smoke.py``'s ``slice_ppi`` and
``slice_mutag_gin``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.data.dataset import InMemoryDataset as JInMemory
from pytorch_geometric_tpu.datasets import TUDataset as JTUDataset
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import (
    Data, DataLoader, InMemoryDataset)
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.examples import mutag_gin, ppi
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.nn.pool import pool_operator
from pytorch_geometric_tpu_torch.ops.csr import real_entries
from pytorch_geometric_tpu_torch.ops.packed_gat import StaticPackedFlashGat
from pytorch_geometric_tpu_torch.ops.sorted_spmm import StaticSegmentSum
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, StaticSpmmOperator)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
EXAMPLES = {"ppi": ppi, "mutag_gin": mutag_gin}


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mutag(root, count=12):
    return TUDataset(str(root), "MUTAG")[:count]


def _mutag_loaders(tmp_path, batch_size=4, shuffle=True):
    """The port's and the JAX package's MUTAG loaders over the same
    synthetic graphs (the JAX dataset needs its ``raw/SYNTHETIC`` marker,
    or it tries a download)."""
    raw = tmp_path / "jax" / "MUTAG" / "raw"
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=0)
    return (DataLoader(_mutag(tmp_path / "port"), device="cpu", **kw),
            JDataLoader(JTUDataset(str(tmp_path / "jax"), "MUTAG")[:12],
                        **kw))


def _ppi_like(count=3, seed=0):
    """PPI-shaped records (50 features, 121 labels) with a repeated pair
    and self loops, of 40-56 nodes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(40, 56))
        s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        s[:4], r[:4] = s[4], r[4]
        s[5:8] = r[5:8]
        out.append(dict(x=rng.normal(size=(n, 50)).astype(np.float32),
                        edge_index=np.stack([np.concatenate([s, r]),
                                             np.concatenate([r, s])]),
                        y=(rng.random((n, 121)) < 0.3).astype(np.float32)))
    return out


class _Port(InMemoryDataset):
    def __init__(self, records):
        self.records = records
        super().__init__(None)

    def process_full(self):
        return [Data(**r) for r in self.records]


class _Jax(JInMemory):
    def __init__(self, records):
        self.records = records
        super().__init__(None)
        self.data_list = [JData(**r) for r in records]


def _ppi_loaders(count=3, batch_size=1, shuffle=True, seed=0):
    records = _ppi_like(count, seed)
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=0)
    return (DataLoader(_Port(records), device="cpu", **kw),
            JDataLoader(_Jax(records), **kw))


def _two_batches(loader):
    """The loader's batches with the most and the fewest real edges, in
    that order: the second leaves stale entries past its own."""
    batches = sorted(loader, key=lambda g: -int(g.edge_mask.sum()))
    big, small = batches[0], batches[-1]
    assert int(big.edge_mask.sum()) > int(small.edge_mask.sum())
    return big, small


def _spoil(csr, *more):
    """Out-of-range values in every slot past the CSR's real entries."""
    nnz = real_entries(csr)
    csr.col[nnz:] = csr.num_cols + 1000
    for t in more:
        t[nnz:] = 1 << 30


def _spmm_call(graph, static):
    fresh = SpmmOperator(graph.senders, graph.receivers, graph.num_nodes,
                         edge_mask=graph.edge_mask, device="cpu")
    if static is not None:
        _spoil(static.load(fresh).fwd)
        _spoil(static.bwd)
    gen = torch.Generator().manual_seed(1)
    w = (torch.rand(graph.num_edges, generator=gen)
         * graph.edge_mask).requires_grad_()
    x = torch.randn(graph.num_nodes, 6, generator=gen).requires_grad_()
    out = (static or fresh)(w, x)
    out.backward(torch.randn(out.shape, generator=gen))
    return out, x.grad, w.grad


def _segment_call(graph, static):
    fresh = pool_operator(graph, device="cpu")
    if static is not None:
        _spoil(static.load(fresh).csr)
    gen = torch.Generator().manual_seed(2)
    msgs = torch.randn(graph.num_nodes, 5, generator=gen).requires_grad_()
    out = (static or fresh)(msgs)
    out.backward(torch.randn(out.shape, generator=gen))
    return out, msgs.grad


def _gat_call(graph, static):
    fresh = ppi.ppi_flash_op(graph)
    if static is not None:
        _spoil(static.load(fresh).fwd)
        _spoil(static.bwd, static.bwd_eid)
    gen = torch.Generator().manual_seed(3)
    H, C, n = 3, 4, graph.num_nodes
    d, s = (torch.randn(n, H, generator=gen).requires_grad_()
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen).requires_grad_()
    out = (static or fresh)(d, s, h, 7, rate=0.6)
    out.backward(torch.randn(out.shape, generator=gen))
    return out, d.grad, s.grad, h.grad


@pytest.mark.parametrize("kind", ["spmm_csr", "segment_sum", "packed_gat"])
def test_a_static_operator_loaded_twice_is_a_fresh_one(tmp_path, kind):
    loader = DataLoader(_mutag(tmp_path), batch_size=4, device="cpu")
    n, e, g = loader.num_nodes, loader.num_edges, loader.num_graphs
    call, static = {
        "spmm_csr": (_spmm_call, StaticSpmmOperator(n, e, device="cpu")),
        "segment_sum": (_segment_call,
                        StaticSegmentSum(g, n, device="cpu")),
        "packed_gat": (_gat_call,
                       StaticPackedFlashGat(n, e + n, device="cpu"))}[kind]
    for graph in _two_batches(loader):
        got, want = call(graph, static), call(graph, None)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_the_real_entries_operator_is_the_padded_one_bitwise(tmp_path):
    loader = DataLoader(_mutag(tmp_path), batch_size=4, device="cpu")
    for graph in loader:
        padded = SpmmOperator(graph.senders, graph.receivers,
                              graph.num_nodes, device="cpu")
        real = mutag_gin.mutag_operators(graph)["spmm_op"]
        assert real.fwd.num_edges == int(graph.edge_mask.sum()) \
            < padded.fwd.num_edges
        w = graph.real_edge_mask().float()
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(graph.num_nodes, 32, generator=gen)
        g = torch.randn(graph.num_nodes, 32, generator=gen)
        outs = []
        for op in (padded, real):
            xi = x.clone().requires_grad_()
            out = op(w, xi)
            out.backward(g)
            outs.append((out, xi.grad))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def _params_close(net, want):
    """Every parameter within TOL of the largest parameter magnitude."""
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= TOL * scale, (name, err, scale)


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def _ppi_jax_step(tmp_path):
    """(loss, JAX loss, the port's model after the step, the JAX
    parameters after it): one SGD step of the port's ``train_step`` over
    static buffers that held another batch first."""
    ref = _jax_example("ppi")
    loader, jloader = _ppi_loaders()
    g0 = next(iter(jloader))
    model = ref.Net()
    params = model.init(jax.random.PRNGKey(3), g0, g0.x)
    next(iter(loader))
    net = ppi.Net()
    net.load_state_dict(params_from_jax(params))
    (_, g), (_, other) = list(loader.indexed())[:2]
    jg = next(iter(jloader))
    static = ppi.static_batch(loader, "cpu")
    for graph in (other, g):
        static.load(graph, {"flash_op": ppi.ppi_flash_op(graph)})

    def loss_fn(p):
        logits = model.apply(p, jg, jg.x)
        bce = optax.sigmoid_binary_cross_entropy(logits, jg.y)
        m = jg.node_mask.astype(jnp.float32)[:, None]
        return jnp.sum(bce * m) / jnp.maximum(jnp.sum(m) * jg.y.shape[1],
                                              1.0)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    params = jax.tree_util.tree_map(lambda p, d: p - 5e-3 * d, params,
                                    grads)
    loss = ppi.train_step(net, torch.optim.SGD(net.parameters(), lr=5e-3),
                          static.graph, static.ops["flash_op"])
    return loss, want, net, params_from_jax(params)


def _mutag_jax_step(tmp_path):
    loader, jloader = _mutag_loaders(tmp_path)
    jnet = _jax_example("mutag_gin").Net(hidden=32, num_classes=2)
    next(iter(loader))
    variables = jnet.init(jax.random.PRNGKey(0), next(iter(jloader)))
    net = mutag_gin.Net(7, 32, 2)
    net.load_state_dict(params_from_jax(variables, mutag_gin.FLAX_NAMES))
    (_, g), (_, other) = list(loader.indexed())[:2]
    jg = next(iter(jloader))
    static = mutag_gin.static_batch(loader, "cpu")
    for graph in (other, g):
        static.load(graph, mutag_gin.mutag_operators(graph))

    def loss_fn(p):
        logits, mut = jnet.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jg,
            train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, jg.y.astype(jnp.int32)[:, None],
                                   axis=1)[:, 0]
        m = jg.graph_mask.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0), mut

    (want, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    params = jax.tree_util.tree_map(lambda p, d: p - 0.01 * d,
                                    variables["params"], grads)
    loss = mutag_gin.train_step(net, torch.optim.SGD(net.parameters(),
                                                     lr=0.01),
                                static.graph, static.ops)
    return loss, want, net, params_from_jax({"params": params},
                                            mutag_gin.FLAX_NAMES)


@pytest.mark.parametrize("name", ["ppi", "mutag_gin"])
def test_one_static_step_matches_the_jax_script(tmp_path, name):
    step = {"ppi": _ppi_jax_step, "mutag_gin": _mutag_jax_step}[name]
    loss, want, net, params = step(tmp_path)
    _close(loss, want)
    _params_close(net, params)


class _Uncaptured(cap.CapturedStep):
    """The captured step's body, called eagerly each time: the static
    buffers' path of ``run(capture=True)`` on the CPU."""

    def __init__(self, body, dev, capture=True):
        super().__init__(body, dev, capture=False)


def _loaders_of(name, tmp_path):
    if name == "ppi":
        return (_ppi_loaders()[0],
                DataLoader(_Port(_ppi_like(2, seed=5)), batch_size=2,
                           device="cpu"))
    return (DataLoader(_mutag(tmp_path), batch_size=4, shuffle=True,
                       device="cpu"),
            DataLoader(_mutag(tmp_path, 5), batch_size=4, device="cpu"))


@pytest.mark.parametrize("name", ["ppi", "mutag_gin"])
def test_the_static_run_is_the_eager_run_bitwise(tmp_path, monkeypatch,
                                                  name):
    module = EXAMPLES[name]
    eager = module.run(2, device="cpu", capture=False,
                       loaders=_loaders_of(name, tmp_path))
    monkeypatch.setattr(module, "resolve_capture", lambda capture, dev: True)
    monkeypatch.setattr(module, "CapturedStep", _Uncaptured)
    loaders = _loaders_of(name, tmp_path)
    static = module.run(2, device="cpu", loaders=loaders)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    metric = "f1" if name == "ppi" else "acc"
    assert static[metric] == eager[metric]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    for k, b in static["model"].named_buffers():
        assert torch.equal(b, dict(eager["model"].named_buffers())[k]), k
    assert static["host_batches"] == 2 * (len(loaders[0]) + len(loaders[1]))
    assert static["device_launches"] == {}
    assert static["operators"] == eager["operators"]


@pytest.mark.parametrize("name", ["ppi", "mutag_gin"])
def test_capture_needs_a_card_and_one_static_shape(tmp_path, name):
    module = EXAMPLES[name]
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        module.run(1, device="cpu", capture=True,
                   loaders=_loaders_of(name, tmp_path))
    train, _ = _loaders_of(name, tmp_path)
    train.dynamic_buckets = True
    with pytest.raises(ValueError, match="dynamic_buckets"):
        module.static_batch(train, "cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cap.CapturedStep(lambda: None, torch.device("cpu"))


def test_static_buffers_refuse_what_does_not_fit(tmp_path):
    loader = DataLoader(_mutag(tmp_path), batch_size=4, device="cpu")
    graph = next(iter(loader))
    small = StaticSpmmOperator(graph.num_nodes, 8, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        small.load(mutag_gin.mutag_operators(graph)["spmm_op"])
    static = mutag_gin.static_batch(loader, "cpu")
    other = DataLoader(_mutag(tmp_path), batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit the static graph"):
        cap.load_graph(static.graph, next(iter(other)))
