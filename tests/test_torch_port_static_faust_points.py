"""The FAUST and pointnet2 steps over static buffers: the port's
counterpart of examples/faust.py's and examples/pointnet2.py's jitted
training and evaluation steps, which a card captures once in a CUDA graph
over the loader's budget and replays for every batch
(``models/capture.py:StepLoop``).

On the CPU, through the kernels' plain versions, at a small size (FAUST
meshes of 50 and 32 vertices padded to 64; ModelNet10 at two samples a
class, batches of 8, the last of 4):

- one SGD step of each script's model over its static buffers (which
  held another batch first) against the JAX script's model and loss on
  the same numpy-seeded batch, from the same parameters (drawn with
  numpy in the flax model's tree, :func:`numpy_params`), dropout off:
  the loss within 1e-5 and the parameters after the step within 1e-5 of
  the largest parameter magnitude;
- the static buffers loaded with two batches of different real sizes in
  turn (a 32-vertex mesh after a 50-vertex one at the same budget; a
  last batch of 4 point clouds after one of 8, its missing graphs
  padding) give bitwise each batch's own tensors' and operators' logits
  and gradients, the operators' spare slots filled with out-of-range
  columns (pointnet2's level-2 gather by sender, whose gradient sums in
  the segment-sum kernel, also against torch's gather, to rounding);
- each script's run through its static buffers with the capture left
  out (``CapturedStep(capture=False)``; FAUST two epochs, pointnet2
  one), FAUST's dropout on and drawn from one seeded generator, bitwise
  the eager run: every step's loss, the accuracy and the final
  parameters;
- ``run(capture=True)`` on the CPU raises.

The card's checks (captured against eager bitwise, the launches by stage:
FAUST 11 ``spmm_csr`` a step and 6 an evaluation batch, pointnet2 one
segment sum a step and none an evaluation batch) are
``chip_smoke.py``'s ``slice_faust`` and ``slice_pointnet2``.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import FAUST as JFAUST
from pytorch_geometric_tpu.datasets import ModelNet as JModelNet
from pytorch_geometric_tpu.transforms import Cartesian as JCartesian
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import FaceToEdge as JFaceToEdge
from pytorch_geometric_tpu.transforms import NormalizeScale as JNormalize
from pytorch_geometric_tpu.transforms import SamplePoints as JSample
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.datasets import FAUST
from pytorch_geometric_tpu_torch.examples import faust, pointnet2
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.ops.csr import real_entries
from pytorch_geometric_tpu_torch.transforms import (
    Cartesian, Compose, FaceToEdge)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
NV = 50          # 5 rings of 10 vertices; padded to 64
EXAMPLES = {"faust": faust, "pointnet2": pointnet2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager steps: one torch thread each, so that workers running
    beside this file do not make every step wait on a crowded pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Uncaptured(cap.CapturedStep):
    """The captured step's body, called eagerly each time: the static
    buffers' path of ``run(capture=True)`` on the CPU."""

    def __init__(self, body, dev, capture=True, generator=None):
        super().__init__(body, dev, capture=False)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _faust(root, num_vertices=NV, train=True):
    return FAUST(str(root), train=train, pre_transform=Compose(
        [FaceToEdge(), Cartesian()]), num_vertices=num_vertices)


def _spoil(static):
    """Out-of-range columns in every slot past each CSR's real entries."""
    for csr in (static.geom.fwd, static.geom.bwd):
        csr.col[real_entries(csr):] = csr.num_cols + 1000


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


def _pass(net, graph, **kw):
    """The net's logits and its gradients, one backward of a fixed
    cotangent."""
    net.zero_grad(set_to_none=True)
    logits = net(graph, **kw)
    logits.backward(torch.linspace(-1, 1, logits.numel()).reshape(
        logits.shape))
    return [logits.detach()] + [p.grad.clone() for p in net.parameters()]


def numpy_params(init, *args, seed=3):
    """Parameters in the tree of ``init(*args)`` (flax's names and
    shapes, from ``jax.eval_shape``: traced, not compiled), drawn with
    numpy from ``seed``: a kernel of two or more axes at 1/sqrt of its
    input width, the rest at 0.1."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        scale = leaf.shape[-2] ** -0.5 if len(leaf.shape) >= 2 else 0.1
        return jnp.asarray(rng.normal(scale=scale, size=leaf.shape)
                           .astype(leaf.dtype))

    return jax.tree_util.tree_map(draw, jax.eval_shape(init, *args))


def _sgd_jax(loss_fn, params, jg):
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jg)
    return loss, jax.tree_util.tree_map(lambda p, d: p - 0.1 * d, params,
                                        grads)


# ---------------------------------------------------------------------------
# FAUST
# ---------------------------------------------------------------------------

def test_faust_static_step_matches_the_jax_step(tmp_path):
    ref = _jax_example("faust")
    port = _faust(tmp_path / "port")[:3]
    jds = JFAUST(str(tmp_path / "jax"), pre_transform=JCompose(
        [JFaceToEdge(), JCartesian()]), num_vertices=NV)[:3]
    loader = DataLoader(port, batch_size=1, device="cpu")
    jloader = JDataLoader(jds, batch_size=1)
    (_, g), (_, other) = list(loader.indexed())[:2]
    jg = next(iter(jloader))
    model = ref.Net(num_vertices=NV)
    key = jax.random.PRNGKey(3)
    params = numpy_params(model.init, {"params": key, "dropout": key}, jg)
    net = faust.Net(NV)
    net.load_state_dict(params_from_jax(params))
    static = faust.static_batch(loader, "cpu")
    for graph in (other, g):
        static.load(graph, {"spline_op": faust.faust_spline_op(graph)})
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    loss = faust.train_step(net, opt, static.graph,
                            static.ops["spline_op"], train=False)

    def loss_fn(p, graph):
        logp = jax.nn.log_softmax(model.apply(p, graph))
        y = graph.y.astype(jnp.int32)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        m = graph.node_mask.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)

    want, params = _sgd_jax(loss_fn, params, jg)
    _close(loss, want)
    _params_close(net, params_from_jax(params))


def test_faust_static_batch_is_each_meshs_own_operator(tmp_path):
    loader = DataLoader(_faust(tmp_path / "a")[:1], batch_size=1,
                        device="cpu")
    big = next(iter(loader))
    small = collate([_faust(tmp_path / "b", 40)[0]],
                    num_nodes=loader.num_nodes, num_edges=loader.num_edges,
                    num_graphs=loader.num_graphs, device="cpu")
    assert int(small.node_mask.sum()) < int(big.node_mask.sum())
    assert int(small.edge_mask.sum()) < int(big.edge_mask.sum())
    net = faust.Net(NV, generator=torch.Generator().manual_seed(0))
    static = faust.static_batch(loader, "cpu")
    for graph in (big, small):
        op = faust.faust_spline_op(graph)
        static.load(graph, {"spline_op": op})
        _spoil(static.ops["spline_op"])
        got = _pass(net, static.graph, spline_op=static.ops["spline_op"])
        want = _pass(net, graph, spline_op=op)
        assert len(got) == len(want) == 1 + len(list(net.parameters()))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _faust_loaders(root):
    return (DataLoader(_faust(root)[:3], batch_size=1, shuffle=True, seed=0,
                       device="cpu"),
            DataLoader(_faust(root, train=False)[:2], batch_size=1,
                       device="cpu"))


# ---------------------------------------------------------------------------
# pointnet2
# ---------------------------------------------------------------------------

def _point_loaders(root, batch_size=8):
    return pointnet2.load(0, batch_size, 2, root, device="cpu")


def _jax_point_loader(root, jmod, batch_size=8):
    jpre = JCompose([JNormalize(), JSample(jmod.N_POINTS),
                     jmod.PrecomputeSetAbstraction()])
    jds = JModelNet(str(root), "10", True, pre_transform=jpre,
                    samples_per_class=2)
    return JDataLoader(jds, batch_size=batch_size, shuffle=True, seed=0)


def test_pointnet2_static_step_matches_the_jax_step(tmp_path):
    """The last, smaller batch (4 clouds and padding) over static buffers
    that held a full one first, one SGD step against the JAX step."""
    ref = _jax_example("pointnet2")
    loader = _point_loaders(tmp_path / "port")[0]
    jloader = _jax_point_loader(tmp_path / "jax", ref)
    batches = list(zip(loader, jloader))
    (full, _), (g, jg) = batches[0], batches[-1]
    assert int(g.graph_mask.sum()) == 4 < int(full.graph_mask.sum())
    model = ref.Net()
    params = numpy_params(model.init, jax.random.PRNGKey(3), jg)
    net = pointnet2.Net()
    net.load_state_dict(params_from_jax(params))
    static = pointnet2.static_batch(loader, "cpu")
    for graph in (full, g):
        static.load(graph, pointnet2.pointnet2_operators(graph))
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    loss = pointnet2.train_step(net, opt, static.graph, static.ops)

    def loss_fn(p, graph):
        logp = jax.nn.log_softmax(model.apply(p, graph))
        y = graph.y.astype(jnp.int32)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        m = graph.graph_mask.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)

    want, params = _sgd_jax(loss_fn, params, jg)
    _close(loss, want)
    _params_close(net, params_from_jax(params))


def test_pointnet2_static_batch_is_each_batchs_own(tmp_path):
    loader = _point_loaders(tmp_path)[0]
    batches = list(loader)
    full, small = batches[0], batches[-1]
    assert int(small.graph_mask.sum()) < int(full.graph_mask.sum())
    net = pointnet2.Net(generator=torch.Generator().manual_seed(0))
    static = pointnet2.static_batch(loader, "cpu")
    for graph in (full, small):
        ops = pointnet2.pointnet2_operators(graph)
        static.load(graph, ops)
        csr = static.ops["sender_op"].csr
        csr.col[real_entries(csr):] = csr.num_cols + 1000
        got = _pass(net, static.graph, **static.ops)
        want = _pass(net, graph, **ops)
        plain = _pass(net, graph)
        assert len(got) == len(want) == 1 + len(list(net.parameters()))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        # the gather by sender against torch's, to rounding
        for a, b in zip(want, plain):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Both: the static run against the eager run, and the switch
# ---------------------------------------------------------------------------

#: Each run's loaders and its ``run``, at its epochs: FAUST's two hold
#: the device curves' second epoch, pointnet2's one its last, padded
#: batch (its steps take most of the file's time).
RUNS = {"faust": (lambda root: _faust_loaders(root),
                  functools.partial(faust.run, 2, seed=0, num_vertices=NV)),
        "pointnet2": (lambda root: _point_loaders(root),
                      functools.partial(pointnet2.run, 1, seed=0))}


@pytest.mark.parametrize("name", ["faust", "pointnet2"])
def test_the_static_run_is_the_eager_run_bitwise(tmp_path, monkeypatch,
                                                  name):
    loaders_of, run = RUNS[name]
    eager = run(device="cpu", capture=False,
                loaders=loaders_of(tmp_path / "a"))
    monkeypatch.setattr(EXAMPLES[name], "resolve_capture",
                        lambda capture, dev: True)
    monkeypatch.setattr(cap, "CapturedStep", _Uncaptured)
    loaders = loaders_of(tmp_path / "b")
    static = run(device="cpu", loaders=loaders)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    assert static["acc"] == eager["acc"]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    epochs = static["step_losses"].shape[0]
    assert epochs == {"faust": 2, "pointnet2": 1}[name]
    assert static["host_batches"] == epochs * (len(loaders[0])
                                               + len(loaders[1]))
    assert static["device_launches"] == {}
    assert sorted(static["launches"]) == ["evaluation", "train"]


@pytest.mark.parametrize("name", ["faust", "pointnet2"])
def test_capture_needs_a_card(tmp_path, name):
    loaders_of, run = RUNS[name]
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        run(device="cpu", capture=True, loaders=loaders_of(tmp_path))
