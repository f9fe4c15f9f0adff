"""examples/qm9_nn_conv.py's step over static buffers: the port's
counterpart of the JAX script's one jitted step and MAE a loader budget,
which a card captures once in a CUDA graph and replays for every batch
(``models/capture.py``), and the operators over the batch's real entries
that it reads (NNConv's sums by receiver and its gather by sender over
the real edges, Set2Set's sums over the real nodes).

On the CPU, through the kernels' plain versions, at a small size (12
synthetic molecules, batches of 4, dim 16):

- one SGD step over the static buffers (which held another batch first)
  against the JAX script's model and loss on the same numpy-seeded
  batch, from the same flax parameters: the loss within 1e-5, the
  gradients within 1e-4 and the parameters after the step within 1e-5
  of the largest magnitude;
- the run through its static buffers with the capture left out
  (``CapturedStep(capture=False)``) bitwise the eager run: every step's
  loss, the MAE and the final parameters;
- NNConv and Set2Set through the operators over the real entries against
  the padded operators (and torch's gather by sender), bitwise on every
  real row, forward and gradient, with the padding graph's row finite;
- ``run(capture=True)`` on the CPU, a ``dynamic_buckets`` loader and a
  batch or operator that does not fit the buffers raise.

The card's check (captured against eager bitwise, the launches by stage)
is ``chip_smoke.py``'s ``slice_qm9``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import QM9 as JQM9
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import Distance as JDistance
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.datasets import QM9
from pytorch_geometric_tpu_torch.examples import qm9_nn_conv
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.nn.pool import Set2Set, pool_operator
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    SortedSegmentSum, StaticSegmentSum)
from pytorch_geometric_tpu_torch.transforms import Compose, Distance

REPO = Path(__file__).resolve().parents[1]
SAMPLES, BATCH, DIM = 12, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager steps: one torch thread each, so that workers running
    beside this file do not make every step wait on a crowded pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's and the JAX script's QM9 datasets over the same
    synthetic molecules (the JAX one warns that it has no network), and
    target 0's mean and standard deviation, built once for the file."""
    root = tmp_path_factory.mktemp("qm9")
    jmod = _jax_example("qm9_nn_conv")
    port = QM9(str(root / "port"), transform=Compose(
        [qm9_nn_conv.Complete(), Distance(norm=False)]),
        num_synthetic=SAMPLES)
    (root / "jax" / "qm9" / "raw").mkdir(parents=True)
    with pytest.warns(UserWarning, match="no network"):
        ref = JQM9(str(root / "jax"), transform=JCompose(
            [jmod.Complete(), JDistance(norm=False)]),
            num_synthetic=SAMPLES)
    ys = np.stack([port.data_list[i].y[0] for i in range(len(port))])
    return jmod, port, ref, float(ys[:, 0].mean()), float(ys[:, 0].std())


def _loaders(data):
    """Fresh (train, test, mean, std) as the script's ``load`` gives them:
    the train loader shuffled from seed 0, the first third the test
    set."""
    _, port, _, mean, std = data
    return (DataLoader(port, batch_size=BATCH, shuffle=True, seed=0,
                       device="cpu"),
            DataLoader(port[:SAMPLES // 3], batch_size=BATCH, device="cpu"),
            mean, std)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _within(state, want, tol):
    """Every tensor of ``state`` within ``tol`` of the largest magnitude
    over ``want``'s same keys."""
    scale = max(float(want[k].abs().max()) for k in state)
    for name, v in state.items():
        err = float((v.detach() - want[name]).abs().max())
        assert err <= tol * scale, (name, err, scale)


def test_one_static_step_matches_the_jax_script(data):
    jmod, _, ref, mean, std = data
    loader = _loaders(data)[0]
    jbatches = list(JDataLoader(ref, batch_size=BATCH, shuffle=True,
                                seed=0))
    jnet = jmod.Net(dim=DIM)
    params = jax.jit(lambda g: jnet.init(jax.random.PRNGKey(3), g))(
        jbatches[0])
    net = qm9_nn_conv.Net(5, 5, dim=DIM)
    net.load_state_dict(params_from_jax(params, qm9_nn_conv.FLAX_NAMES))
    (_, g), (_, other) = list(loader.indexed())[:2]
    jg = jbatches[0]
    static = qm9_nn_conv.static_batch(loader, "cpu")
    for graph in (other, g):
        static.load(graph, qm9_nn_conv.qm9_operators(graph))

    def loss_fn(p):
        pred = jnet.apply(p, jg)
        target = (jg.y[:, 0] - mean) / (std + 1e-12)
        m = jg.graph_mask.astype(jnp.float32)
        return jnp.sum(((pred - target) ** 2) * m) / jnp.maximum(m.sum(), 1)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    lr = 1e-3
    loss = qm9_nn_conv.train_step(
        net, torch.optim.SGD(net.parameters(), lr=lr), static.graph,
        static.ops, mean, std)
    _close(loss, want, 1e-5)
    trained = {k: p for k, p in net.named_parameters() if p.requires_grad}
    _within({k: p.grad for k, p in trained.items()},
            params_from_jax(grads, qm9_nn_conv.FLAX_NAMES), 1e-4)
    stepped = jax.tree_util.tree_map(lambda p, d: p - lr * d, params, grads)
    _within(trained, params_from_jax(stepped, qm9_nn_conv.FLAX_NAMES), 1e-5)


class _Uncaptured(cap.CapturedStep):
    """The captured step's body, called eagerly each time: the static
    buffers' path of ``run(capture=True)`` on the CPU."""

    def __init__(self, body, dev, capture=True, generator=None):
        super().__init__(body, dev, capture=False, generator=generator)


def test_the_static_run_is_the_eager_run_bitwise(data, monkeypatch):
    eager = qm9_nn_conv.run(2, device="cpu", capture=False,
                            loaders=_loaders(data))
    monkeypatch.setattr(qm9_nn_conv, "resolve_capture",
                        lambda capture, dev: True)
    monkeypatch.setattr(qm9_nn_conv, "CapturedStep", _Uncaptured)
    loaders = _loaders(data)
    static = qm9_nn_conv.run(2, device="cpu", loaders=loaders)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    assert static["mae"] == eager["mae"]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    assert static["host_batches"] == 2 * (len(loaders[0]) + len(loaders[1]))
    assert static["device_launches"] == {}
    assert static["operators"] == eager["operators"]


def test_nnconv_and_set2set_over_the_real_entries_are_the_padded_ones(
        data):
    """A QM9 batch's NNConv (the model's, three rounds with the GRU) and
    Set2Set through :func:`qm9_operators` (real edges by receiver and by
    sender, real nodes by graph) against the operators over every slot
    and torch's gather: the output and every gradient bitwise, on the
    real rows; the padding graph's row finite."""
    loader = _loaders(data)[0]
    graph = next(iter(loader))
    real = qm9_nn_conv.qm9_operators(graph)
    n, e = graph.num_nodes, graph.num_edges
    assert real["segment_op"].csr.num_edges == \
        real["sender_op"].csr.num_edges == int(graph.edge_mask.sum()) < e
    assert real["pool_op"].csr.num_edges == int(graph.node_mask.sum()) < n
    padded = {"segment_op": SortedSegmentSum(graph.receivers, n,
                                             device="cpu"),
              "pool_op": SortedSegmentSum(real["pool_op"].receivers,
                                          graph.num_graphs, device="cpu")}
    net = qm9_nn_conv.Net(5, 5, dim=DIM,
                          generator=torch.Generator().manual_seed(2))
    s2s = Set2Set(DIM, 3, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(n, DIM, generator=gen)
    gout = torch.randn(graph.num_graphs, 2 * DIM, generator=gen)
    outs = []
    for ops in (real, padded):
        net.zero_grad()
        s2s.zero_grad()
        xi = x.clone().requires_grad_()
        h = xi
        for _ in range(3):
            m = torch.relu(net.NNConv_0(graph, h, segment_op=ops[
                "segment_op"], sender_op=ops.get("sender_op")))
            h = net.GRUCell_0(m, h)
        out = s2s(h, graph, segment_op=ops["pool_op"])
        out.backward(gout)
        outs.append((out, xi.grad,
                     [p.grad.clone() for p in net.NNConv_0.parameters()],
                     [p.grad.clone() for p in s2s.parameters()
                      if p.requires_grad]))
    (out, dx, conv_grads, s2s_grads), want = outs
    rows, nodes = graph.graph_mask, graph.node_mask
    assert torch.equal(out[rows], want[0][rows])
    assert torch.equal(dx[nodes], want[1][nodes])
    for a, b in zip(conv_grads + s2s_grads, want[2] + want[3]):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(out).all() and torch.isfinite(dx).all())


def test_capture_needs_a_card_one_static_shape_and_a_fit(data):
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        qm9_nn_conv.run(1, device="cpu", capture=True,
                        loaders=_loaders(data))
    train = _loaders(data)[0]
    train.dynamic_buckets = True
    with pytest.raises(ValueError, match="dynamic_buckets"):
        qm9_nn_conv.static_batch(train, "cpu")
    train.dynamic_buckets = False
    graph = next(iter(train))
    static = qm9_nn_conv.static_batch(train, "cpu")
    small = DataLoader(data[1], batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit the static graph"):
        static.load(next(iter(small)), qm9_nn_conv.qm9_operators(graph))
    seg = StaticSegmentSum(train.num_nodes, 8, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        seg.load(qm9_nn_conv.qm9_operators(graph)["segment_op"])
    pool = StaticSegmentSum(train.num_graphs, train.num_nodes,
                            device="cpu")
    pool.load(pool_operator(graph, device="cpu"))
    assert int(pool.csr.row_ptr[-1]) == int(graph.node_mask.sum())
