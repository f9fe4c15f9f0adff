"""Port parity, slice 16: ``PackedFlashGat``'s reference contract and
examples/ppi.py.

- ``PackedFlashGat(adj_bool=...)`` and ``PackedFlashGat(senders=...,
  receivers=..., num_nodes=...)`` with repeated pairs, at attention
  dropout 0.6, forward and VJP (the kernels' plain versions on the CPU):
  against the JAX ``PackedFlashGat`` built from the same numpy inputs,
  2e-2 of the largest magnitude forward and 5e-2 in relative L2 for the
  gradients (the JAX operator rounds its gathers and scatters to bf16,
  as ``tests/test_torch_port_gat.py`` states); and against an fp32
  reference in the JAX package's own ops (its segment softmax and sum
  over the same edge list, its ``_edge_keep_bits`` of each edge's input
  index), 1e-5 forward and 1e-4 for the gradients.
- ``gat_sparse_edge_set``: the sparse path's softmax slots.
- The example's ``Net`` against the JAX script's ``Net`` (loaded from
  ``examples/ppi.py`` by path), from the same flax parameters
  (``convert.params_from_jax``), on PPI-like graphs with repeated edges
  and self loops collated by each package's ``DataLoader``: the port
  through its fused operator, the JAX script through ``GATConv``'s sparse
  path. Logits 1e-5, gradients 1e-4; three Adam steps against
  ``optax.adam``: each step's loss 1e-5, then the logits 1e-4 and each
  parameter 1e-4 in relative L2; and ``gat_edge_set``'s operator, which
  collapses repeated edges, does not match.
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
from pytorch_geometric_tpu.ops import segment as jseg
from pytorch_geometric_tpu.ops.packed_gat import PackedFlashGat as JPacked
from pytorch_geometric_tpu.ops.packed_gat import _edge_keep_bits
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, DataLoader, InMemoryDataset
from pytorch_geometric_tpu_torch.examples import ppi
from pytorch_geometric_tpu_torch.nn.conv import (
    gat_edge_set, gat_sparse_edge_set)
from pytorch_geometric_tpu_torch.ops import packed_gat as pg

REPO = Path(__file__).resolve().parents[1]
H, C, SEED, RATE = 3, 4, 11, 0.6


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "reference_examples_ppi", REPO / "examples" / "ppi.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# PackedFlashGat's contract
# ---------------------------------------------------------------------------

def _edges(kind, n=150, seed=0):
    """(port constructor keywords, JAX constructor keywords, senders,
    receivers) of a dense mask (edge order: its ``np.nonzero``) or of a
    receiver-sorted list with repeated pairs and senders in no order
    within a receiver."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, 700), rng.integers(0, n, 700)
    if kind == "mask":
        adj = np.zeros((n, n), bool)
        adj[r, s] = True
        adj[np.arange(n), np.arange(n)] = True
        r, s = np.nonzero(adj)
        return dict(adj_bool=adj), dict(adj_bool=adj), s, r
    s = np.concatenate([s, s[:60], np.arange(n)])      # 60 repeated pairs
    r = np.concatenate([r, r[:60], np.arange(n)])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    kw = dict(senders=s, receivers=r, num_nodes=n)
    return kw, kw, s, r


def _node_inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]


def _fp32_reference(senders, receivers, n):
    """The operator's function in the JAX package's fp32 ops: per-receiver
    softmax of leaky(s[src] + d[dst]), dropout of the normalised weights by
    ``_edge_keep_bits`` of each edge's input index, weighted sum."""
    sj, rj = jnp.asarray(senders), jnp.asarray(receivers)
    eid = jnp.arange(senders.shape[0], dtype=jnp.int32)[:, None]
    bits = _edge_keep_bits(jnp.asarray(SEED, jnp.int32), eid,
                           jnp.arange(H, dtype=jnp.int32)[None])
    keep = bits >= jnp.uint32(pg.dropout_threshold(RATE))
    scale = pg.dropout_scale(RATE)

    def fn(d, s, h):
        z = jax.nn.leaky_relu(jnp.take(s, sj, axis=0)
                              + jnp.take(d, rj, axis=0), 0.2)
        alpha = jseg.segment_softmax(z, rj, n)
        alpha = jnp.where(keep, alpha * scale, 0.0)
        msgs = jnp.take(h.reshape(n, H, C), sj, axis=0) * alpha[..., None]
        return jseg.segment_sum(msgs, rj, n).reshape(n, H * C)
    return fn


@pytest.mark.parametrize("kind", ["mask", "duplicates"])
@pytest.mark.parametrize("reference", ["jax_packed", "jax_fp32"])
def test_packed_flash_gat_takes_the_reference_contract(kind, reference):
    port_kw, jax_kw, senders, receivers = _edges(kind)
    n = 150
    op = pg.PackedFlashGat(**port_kw, device="cpu")
    assert (op.n, op.E) == (n, senders.size)
    # the CSR position is the input index, which dropout hashes
    np.testing.assert_array_equal(op.fwd.col.numpy(), senders)
    np.testing.assert_array_equal(op.fwd.perm.numpy(), np.arange(op.E))
    d, s, h, proj = _node_inputs(n)
    ts = [torch.from_numpy(a).requires_grad_() for a in (d, s, h)]
    out = op(*ts, SEED, rate=RATE)
    (out * torch.from_numpy(proj)).sum().backward()
    if reference == "jax_packed":
        jop = JPacked(**jax_kw, window=128, tile=128)
        fn = lambda d, s, h: jop(d, s, h, float(SEED), rate=RATE)  # noqa
    else:
        fn = _fp32_reference(senders, receivers, n)
    want = fn(d, s, h)
    want_grads = jax.grad(lambda d, s, h: jnp.sum(fn(d, s, h) * proj),
                          argnums=(0, 1, 2))(d, s, h)
    if reference == "jax_packed":
        _close(out, want, 2e-2)
        for t, b in zip(ts, want_grads):
            b = np.asarray(b)
            assert np.linalg.norm(t.grad.numpy() - b) \
                <= 5e-2 * np.linalg.norm(b)
    else:
        _close(out, want, 1e-5)
        for t, b in zip(ts, want_grads):
            _close(t.grad, b, 1e-4)


def test_repeated_pairs_are_slots_of_their_own():
    """A pair given twice weighs twice in its receiver's softmax, as on
    the sparse path (and unlike the dense mask's one entry)."""
    once = pg.PackedFlashGat(senders=[0, 1, 2], receivers=[2, 2, 2],
                             num_nodes=3, device="cpu")
    twice = pg.PackedFlashGat(senders=[0, 0, 1, 2], receivers=[2, 2, 2, 2],
                              num_nodes=3, device="cpu")
    d, s = torch.zeros(3, 1), torch.zeros(3, 1)
    h = torch.tensor([[3.0], [0.0], [0.0]])
    assert float(once(d, s, h, 0)[2, 0]) == pytest.approx(1.0)
    assert float(twice(d, s, h, 0)[2, 0]) == pytest.approx(1.5)


# ---------------------------------------------------------------------------
# examples/ppi.py
# ---------------------------------------------------------------------------

def _ppi_like(count=3, seed=0):
    """PPI-like graphs of ~64 nodes: 50 features, 121 labels, random
    pairs in both directions (repeats among them) and a few self loops."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(56, 72))
        s, r = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        s[:4], r[:4] = s[4], r[4]                       # a repeated pair
        s[5:8] = r[5:8]                                 # self loops
        ei = np.stack([np.concatenate([s, r]), np.concatenate([r, s])])
        out.append(dict(x=rng.normal(size=(n, 50)).astype(np.float32),
                        edge_index=ei,
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


def _loaders(batch_size, shuffle=False):
    records = _ppi_like()
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=0)
    return (DataLoader(_Port(records), device="cpu", **kw),
            JDataLoader(_Jax(records), **kw))


def test_sparse_edge_set_is_the_sparse_paths_softmax_slots():
    loader, _ = _loaders(2)
    g = next(iter(loader))
    s, r = gat_sparse_edge_set(g)
    assert (np.diff(r) >= 0).all()
    real = g.edge_mask.numpy()
    gs, gr = g.senders.numpy()[real], g.receivers.numpy()[real]
    keep = gs != gr
    want = np.concatenate([gr[keep] * g.num_nodes + gs[keep],
                           np.arange(g.num_nodes) * (g.num_nodes + 1)])
    np.testing.assert_array_equal(np.sort(r * g.num_nodes + s),
                                  np.sort(want))
    assert np.unique(want).size < want.size        # repeats are kept
    # each node's loop follows its real edges
    last = np.flatnonzero(np.r_[r[1:] != r[:-1], True])
    np.testing.assert_array_equal(s[last], r[last])
    assert (s == r).sum() == g.num_nodes


def _jax_model_and_params():
    ref = _jax_example()
    _, jl = _loaders(2)
    g0 = next(iter(jl))
    model = ref.Net()
    return ref, model, model.init(jax.random.PRNGKey(3), g0, g0.x)


def _port_model(params):
    model = ppi.Net()
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_loss(model, params, graph):
    logits = model.apply(params, graph, graph.x)
    bce = optax.sigmoid_binary_cross_entropy(logits, graph.y)
    m = graph.node_mask.astype(jnp.float32)[:, None]
    return jnp.sum(bce * m) / jnp.maximum(jnp.sum(m) * graph.y.shape[1],
                                          1.0)


def _grads_by_name(grads):
    return params_from_jax(grads)


@pytest.mark.parametrize("edge_set", ["sparse", "gat_edge_set"])
def test_ppi_net_matches_the_jax_example(edge_set):
    """Logits and every parameter's gradient of the loss, on a batch of
    two graphs; ``gat_edge_set``'s operator, which collapses the repeated
    pairs, gives other logits."""
    _, model, params = _jax_model_and_params()
    net = _port_model(params)
    loader, jloader = _loaders(2)
    g, jg = next(iter(loader)), next(iter(jloader))
    if edge_set == "sparse":
        op = ppi.ppi_flash_op(g)
    else:
        s, r = gat_edge_set(g)
        op = pg.PackedFlashGat(senders=s, receivers=r,
                               num_nodes=g.num_nodes, device="cpu")
    logits = net(g, g.x, flash_op=op)
    want = jax.jit(model.apply)(params, jg, jg.x)
    if edge_set == "gat_edge_set":
        rel = float(np.abs(logits.detach().numpy() - np.asarray(want)).max()
                    / np.abs(np.asarray(want)).max())
        assert rel > 1e-3
        return
    _close(logits, want, 1e-5)
    ppi.bce_loss(logits, g).backward()
    want_grads = _grads_by_name(jax.jit(jax.grad(
        lambda p: _jax_loss(model, p, jg)))(params))
    grads = dict(net.named_parameters())
    assert sorted(grads) == sorted(want_grads)
    for name, p in grads.items():
        _close(p.grad, want_grads[name].numpy(), 1e-4)


def test_three_adam_steps_match_optax():
    """Three steps of the example's ``train_step`` (Adam 5e-3) against
    the JAX script's step with ``optax.adam``, over the batches of one
    shuffled epoch of each package's loader, one operator per batch."""
    _, model, params = _jax_model_and_params()
    net = _port_model(params)
    opt = torch.optim.Adam(net.parameters(), lr=5e-3)
    tx = optax.adam(5e-3)
    state = tx.init(params)
    loader, jloader = _loaders(1, shuffle=True)
    ops = ppi.OperatorCache()
    batches = list(zip(loader.indexed(), jloader))
    assert len(batches) == 3
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, graph: _jax_loss(model, p, graph)))
    for (idx, g), jg in batches:
        loss = ppi.train_step(net, opt, g, ops(idx, g))
        want, grads = value_and_grad(params, jg)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _close(loss, want, 1e-5)
    # Each parameter within 1e-4 in relative L2 norm, not element by
    # element: Adam divides each element's mean gradient by its root mean
    # square, so an element whose gradients are near 0 takes a step set
    # by its rounding (one of lin2's 1,048,576 differs by 1.3e-5 after
    # three steps, 2% of itself, while the gradients agree within 1e-4).
    want = params_from_jax(params)
    for name, p in net.named_parameters():
        b = want[name].numpy()
        assert np.linalg.norm(p.detach().numpy() - b) \
            <= 1e-4 * np.linalg.norm(b), name
    (idx, g), jg = batches[0]
    with torch.no_grad():
        logits = net(g, g.x, flash_op=ops(idx, g))
    _close(logits, model.apply(params, jg, jg.x), 1e-4)
    assert len(ops.ops) == 3 and ops.seconds > 0


def test_example_run_builds_one_operator_per_batch_and_launches_nothing():
    loaders = _loaders(1, shuffle=True)
    val = DataLoader(_Port(_ppi_like(2, seed=5)), batch_size=2,
                     device="cpu")
    before = (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches)
    out = ppi.run(2, loaders=(loaders[0], val), device="cpu")
    assert out["operators"] == 3 + 1
    assert out["step_losses"].shape == (2, 3)
    assert np.isfinite(out["step_losses"]).all()
    assert 0.0 <= out["f1"] <= 1.0
    assert (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches) == before
    pred = np.array([[1.0, 0.0], [1.0, 1.0]])
    y = np.array([[1.0, 1.0], [0.0, 1.0]])
    assert ppi.micro_f1(pred, y, np.array([True, True])) == pytest.approx(
        _jax_example().micro_f1(pred, y, np.array([True, True])))
