"""The superpixel examples' steps over static buffers
(examples/mnist_graclus.py, mnist_voxel_grid.py, mnist_nn_conv.py): the
port's counterpart of the JAX scripts' one jitted step a loader budget,
which a card captures once in a CUDA graph and replays for every batch
(``models/capture.py``), and the operators over the batch's real entries
that it reads.

On the CPU, through the kernels' plain versions, at a small size (12
synthetic superpixel graphs, batches of 4):

- one SGD step of each script's model over its static buffers (which
  held another batch first) against the JAX script's model and loss on
  the same numpy-seeded batch, from the same flax parameters, dropout
  off: the loss within 1e-5, the gradients within 1e-4 and the
  parameters after the step within 1e-5 of the largest magnitude;
- each script's run through its static buffers with the capture left
  out (``CapturedStep(capture=False)``), dropout on and drawn from one
  seeded generator, bitwise the eager run: every step's loss, the
  accuracy and the final parameters;
- the operators over the real entries (the pools' ``cluster_operator``,
  the readout's ``pool_operator``, NNConv's sums by receiver and its
  gather by sender) against the padded ones, bitwise on every real row,
  forward and gradient, also on a batch with one padding node and on a
  graph whose row N - 1 is a real cluster; the padding graph's row
  finite;
- the static rectangular spline operator and the static segment sum
  with spare slots, loaded with two batches in turn, bitwise a freshly
  built operator;
- ``run(capture=True)`` on the CPU, a captured step with a generator on
  the CPU, a ``dynamic_buckets`` loader and operators that do not fit
  the buffers raise.

The card's checks (captured against eager bitwise, the launches by stage)
are ``chip_smoke.py``'s ``slice_mnist_graclus``, ``slice_mnist_voxel_grid``
and ``slice_mnist_nn_conv``.
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
from pytorch_geometric_tpu.datasets import MNISTSuperpixels as JMNIST
from pytorch_geometric_tpu.transforms import Cartesian as JCartesian
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms.coarsen_levels import (
    PrecomputeGraclusCoarsening as JGraclusLevels)
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.examples import (
    mnist_graclus, mnist_nn_conv, mnist_voxel_grid)
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.nn.conv import (
    NNConv, spline_operator, static_spline_operator)
from pytorch_geometric_tpu_torch.nn.pool import (
    cluster_operator, global_add_pool, global_mean_pool, pool_graph_masked,
    pool_operator)
from pytorch_geometric_tpu_torch.nn.pool.coarsen import _routed
from pytorch_geometric_tpu_torch.ops.csr import real_entries
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    SortedSegmentSum, StaticSegmentSum)

REPO = Path(__file__).resolve().parents[1]
SAMPLES, BATCH = 12, 4      # three train batches; test set 12 // 6
EXAMPLES = {"mnist_graclus": mnist_graclus,
            "mnist_voxel_grid": mnist_voxel_grid,
            "mnist_nn_conv": mnist_nn_conv}


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
    """Each script's port datasets (train, test) and JAX train dataset
    over the same synthetic graphs, built once for the file."""
    root = tmp_path_factory.mktemp("superpixels")
    voxel = _jax_example("mnist_voxel_grid")
    out = {}
    for levels in ("graclus", "voxel"):
        if levels == "graclus":
            port = mnist_graclus.load(0, BATCH, SAMPLES, root / "port",
                                      device="cpu")
            jpre = JCompose([JCartesian(), JGraclusLevels(levels=2)])
        else:
            port = mnist_voxel_grid.load(0, BATCH, SAMPLES,
                                         root / "port_voxel", device="cpu")
            jpre = JCompose([JCartesian(), voxel.PrecomputeVoxelLevels()])
        jds = JMNIST(str(root / f"jax_{levels}"), True, pre_transform=jpre,
                     num_synthetic=SAMPLES)
        out[levels] = (port[0].dataset, port[1].dataset, jds)
    return out


def _loaders(data, levels):
    """Fresh port loaders (train shuffled from seed 0, test) over the
    file's datasets: the scripts' ``load``."""
    train, test, _ = data[levels]
    return (DataLoader(train, batch_size=BATCH, shuffle=True, seed=0,
                       device="cpu"),
            DataLoader(test, batch_size=BATCH, device="cpu"))


def _levels(name):
    return "graclus" if name == "mnist_graclus" else "voxel"


# ---------------------------------------------------------------------------
# (a) one static step against the JAX script's
# ---------------------------------------------------------------------------

def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _within(state, want, tol):
    """Every tensor of ``state`` within ``tol`` of the largest magnitude
    over ``want``."""
    assert sorted(state) == sorted(want)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, v in want.items():
        err = float((state[name] - v).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_one_static_step_matches_the_jax_script(name, data):
    loader, _ = _loaders(data, _levels(name))
    jloader = JDataLoader(data[_levels(name)][2], batch_size=BATCH,
                          shuffle=True, seed=0)
    nn_conv = name == "mnist_nn_conv"
    jnet = _jax_example("mnist_nn_conv" if nn_conv else
                        "mnist_graclus").Net()
    names = mnist_nn_conv.FLAX_NAMES if nn_conv else None
    net = mnist_nn_conv.Net() if nn_conv else mnist_graclus.Net()
    jbatches = list(jloader)
    key = jax.random.PRNGKey(7)
    params = jax.jit(lambda g: jnet.init({"params": key, "dropout": key},
                                         g))(jbatches[0])
    net.load_state_dict(params_from_jax(params, names))
    (_, g), (_, other) = list(loader.indexed())[:2]
    jg = jbatches[0]
    static = mnist_graclus.static_batch(loader, "cpu", segment_ops=nn_conv)
    for graph in (other, g):
        static.load(graph, mnist_graclus.mnist_operators(
            graph, segment_ops=nn_conv))

    def loss_fn(p):
        logp = jax.nn.log_softmax(jnet.apply(p, jg))
        nll = -jnp.take_along_axis(logp, jg.y.astype(jnp.int32)[:, None],
                                   axis=1)[:, 0]
        m = jg.graph_mask.astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    lr = 0.01
    loss = mnist_graclus.train_step(
        net, torch.optim.SGD(net.parameters(), lr=lr), static.graph,
        static.ops, train=False)
    _close(loss, want, 1e-5)
    _within({k: p.grad for k, p in net.named_parameters()},
            params_from_jax(grads, names), 1e-4)
    stepped = jax.tree_util.tree_map(lambda p, d: p - lr * d, params, grads)
    _within(dict(net.named_parameters()), params_from_jax(stepped, names),
            1e-5)


# ---------------------------------------------------------------------------
# (b) the static run is the eager run, bitwise, dropout on
# ---------------------------------------------------------------------------

class _Uncaptured(cap.CapturedStep):
    """The captured step's body, called eagerly each time: the static
    buffers' path of ``run(capture=True)`` on the CPU."""

    def __init__(self, body, dev, capture=True, generator=None):
        super().__init__(body, dev, capture=False, generator=generator)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_the_static_run_is_the_eager_run_bitwise(name, data, monkeypatch):
    module = EXAMPLES[name]
    eager = module.run(2, device="cpu", capture=False,
                       loaders=_loaders(data, _levels(name)))
    monkeypatch.setattr(module, "resolve_capture", lambda capture, dev: True)
    monkeypatch.setattr(mnist_graclus, "CapturedStep", _Uncaptured)
    loaders = _loaders(data, _levels(name))
    static = module.run(2, device="cpu", loaders=loaders)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    # dropout was on: the same steps without it give other losses
    assert static["acc"] == eager["acc"]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    assert static["host_batches"] == 2 * (len(loaders[0]) + len(loaders[1]))
    assert static["host_geometry_seconds"] > 0.0
    assert static["device_launches"] == {}
    assert static["operators"] == eager["operators"]


def test_the_mnist_step_draws_dropout_from_its_generator(data):
    """Two steps from one generator draw two masks: the second step's
    loss differs from a step that redraws the first mask."""
    loader, _ = _loaders(data, "graclus")
    (idx, g), = list(loader.indexed())[:1]
    ops = mnist_graclus.mnist_operators(g)
    losses = []
    for seeds in ((0, None), (0, 0)):
        net = mnist_graclus.Net(generator=torch.Generator().manual_seed(1))
        opt = torch.optim.SGD(net.parameters(), lr=0.0)
        gen = torch.Generator().manual_seed(seeds[0])
        out = []
        for s in seeds:
            if s is not None:
                gen.manual_seed(s)
            out.append(mnist_graclus.train_step(net, opt, g, ops, gen))
        losses.append(out)
    assert torch.equal(losses[0][0], losses[1][0])
    assert torch.equal(losses[1][0], losses[1][1])
    assert not torch.equal(losses[0][0], losses[0][1])


@pytest.mark.parametrize("name", ["mnist_graclus", "mnist_nn_conv"])
def test_each_step_calls_the_kernel_wrappers_chip_smoke_counts(
        name, data, monkeypatch):
    """The wrappers' calls of one training step and one evaluation batch
    over the static buffers equal the counts ``chip_smoke.py`` holds the
    card's launches to (``MNIST_STEP_LAUNCHES``, ``POINT_EXAMPLES``; the
    voxel script runs mnist_graclus's step). On the CPU the wrappers
    compute their plain versions and count no launch, so their calls are
    counted here."""
    import chip_smoke
    from pytorch_geometric_tpu_torch.ops import sorted_spmm, spmm

    calls = {}
    for module, fn in ((spmm, "spmm_csr"),
                       (sorted_spmm, "sorted_segment_sum")):
        orig = getattr(module, fn)

        def counted(*args, _orig=orig, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args)

        monkeypatch.setattr(module, fn, counted)
    nn_conv = name == "mnist_nn_conv"
    step, evaluation = (chip_smoke.POINT_EXAMPLES[name][1:] if nn_conv else
                        (chip_smoke.MNIST_STEP_LAUNCHES,
                         chip_smoke.MNIST_EVAL_LAUNCHES))
    loader, _ = _loaders(data, "voxel" if nn_conv else "graclus")
    net = mnist_nn_conv.Net() if nn_conv else mnist_graclus.Net()
    static = mnist_graclus.static_batch(loader, "cpu", segment_ops=nn_conv)
    graph = next(iter(loader))
    static.load(graph, mnist_graclus.mnist_operators(graph,
                                                     segment_ops=nn_conv))
    mnist_graclus.train_step(net, torch.optim.Adam(net.parameters()),
                             static.graph, static.ops,
                             torch.Generator().manual_seed(0))
    assert calls == step
    calls.clear()
    mnist_graclus.counts_of(net, static.graph, static.ops)
    assert calls == evaluation


# ---------------------------------------------------------------------------
# (c) the operators over the real entries against the padded ones
# ---------------------------------------------------------------------------

def _padded(op, rows):
    """The operator over every entry of ``op``'s receivers."""
    return SortedSegmentSum(op.receivers, rows, device="cpu")


def _pool_case(graph, cluster, reduce):
    """``pool_graph_masked`` through ``cluster_operator`` and through the
    padded operator: (pooled x, pooled pos, dx) each."""
    real = cluster_operator(cluster, graph, device="cpu")
    padded = _padded(real, graph.num_nodes)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(graph.num_nodes, 5, generator=gen)
    gout = torch.randn(graph.num_nodes, 5, generator=gen)
    outs = []
    for op in (real, padded):
        xi = x.clone().requires_grad_()
        g = pool_graph_masked(cluster, graph.replace(x=xi), reduce=reduce,
                              segment_op=op)
        g.x.backward(gout)
        outs.append((g.x, g.pos, xi.grad))
    return real, padded, outs


def _one_padding_node(loader):
    """A batch of the loader's first graphs collated with exactly one
    padding node (the budget filled as far as a collation allows)."""
    datas = [loader.dataset[i] for i in range(BATCH)]
    n = sum(d.num_nodes for d in datas)
    return collate(datas, num_nodes=n + 1, num_edges=loader.num_edges,
                   num_graphs=loader.num_graphs, device="cpu")


@pytest.mark.parametrize("reduce", ["mean", "add"])
def test_the_cluster_operator_over_the_real_nodes_is_the_padded_one(
        reduce, data):
    loader, _ = _loaders(data, "graclus")
    graphs = [next(iter(loader)), _one_padding_node(loader)]
    for graph in graphs:
        for key, level in (("cluster1", graph),
                           ("cluster2",
                            mnist_graclus.coarsened_levels(graph)[0])):
            cluster = graph.extras[key]
            real, padded, (got, want) = _pool_case(level, cluster, reduce)
            nm = level.real_node_mask()
            assert real.csr.num_edges == int(nm.sum()) \
                < padded.csr.num_edges
            # every row: the padding nodes handed 0 to the sums, and the
            # mean's row N - 1 reads 0 / count = 0 either way
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert bool(torch.isfinite(got[0]).all())


def test_a_real_cluster_on_row_n_minus_1_keeps_every_entry(data):
    """A graph with no padding node whose row N - 1 is a real cluster,
    with masked nodes in the middle (routed to N - 1, as the JAX pool
    routes them): the operator keeps every entry, and the mean of that
    row counts the routed nodes, as the JAX mean does."""
    loader, _ = _loaders(data, "graclus")
    g = next(iter(loader))
    n = g.num_nodes
    nm = torch.ones(n, dtype=torch.bool)
    nm[5:9] = False
    cluster = g.extras["cluster1"].clone()
    cluster[n - 3:] = n - 1
    graph = g.replace(node_mask=nm, batch=torch.zeros(n, dtype=torch.int32))
    real, padded, (got, want) = _pool_case(graph, cluster, "mean")
    assert real.csr.num_edges == padded.csr.num_edges == n
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    routed = _routed(cluster, graph)
    assert int((routed == n - 1).sum()) == 3 + 4


@pytest.mark.parametrize("kind", ["mean", "add"])
def test_the_readout_over_the_real_nodes_is_the_padded_one(kind, data):
    loader, _ = _loaders(data, "graclus")
    g = next(iter(loader))
    g2 = mnist_graclus.coarsened_levels(g)[1]
    pool = global_mean_pool if kind == "mean" else global_add_pool
    for level in (g, g2):
        real = pool_operator(level, device="cpu")
        padded = _padded(real, level.num_graphs)
        assert real.csr.num_edges == int(level.node_mask.sum()) \
            < padded.csr.num_edges
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(level.num_nodes, 6, generator=gen)
        gout = torch.randn(level.num_graphs, 6, generator=gen)
        outs = []
        for op in (real, padded):
            xi = x.clone().requires_grad_()
            out = pool(xi, level, segment_op=op)
            out.backward(gout)
            outs.append((out, xi.grad))
        (out, dx), (want, want_dx) = outs
        rows, nodes = level.graph_mask, level.node_mask
        assert torch.equal(out[rows], want[rows])
        assert torch.equal(dx[nodes], want_dx[nodes])
        # the padding graph's row stays finite (the masked loss reads it)
        assert bool(torch.isfinite(out).all() and torch.isfinite(dx).all())


def test_nnconv_sums_over_the_real_edges_are_the_padded_ones(data):
    """NNConv (mean) at both levels of an nn_conv batch through its
    operators over the real edges (``segment1`` / ``segment2`` by
    receiver, ``senders2`` by sender) against the padded operator by
    receiver and torch's gather: forward and every gradient bitwise on
    the real rows (level 1's kept no collapsed self loop)."""
    loader, _ = _loaders(data, "voxel")
    g = next(iter(loader))
    ops = mnist_graclus.mnist_operators(g, segment_ops=True)
    g1 = mnist_graclus.device_cartesian(
        mnist_graclus.coarsened_levels(g)[0])
    torch.manual_seed(0)
    conv = NNConv(3, 4, mnist_nn_conv.EdgeNN(2, 3 * 4), aggr="mean")
    for level, recv, send in ((g, "segment1", None),
                              (g1, "segment2", "senders2")):
        real = ops[recv]
        assert real.csr.num_edges == int(level.edge_mask.sum()) \
            < real.receivers.shape[0]
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(level.num_nodes, 3, generator=gen)
        gout = torch.randn(level.num_nodes, 4, generator=gen)
        outs = []
        for seg, sender in ((real, ops.get(send)),
                            (_padded(real, level.num_nodes), None)):
            conv.zero_grad()
            xi = x.clone().requires_grad_()
            out = conv(level, xi, segment_op=seg, sender_op=sender)
            out.backward(gout)
            outs.append([out, xi.grad] + [p.grad.clone()
                                          for p in conv.parameters()])
        m = level.real_node_mask()
        for a, b in zip(*outs):
            if a.shape[:1] == m.shape:
                a, b = a[m], b[m]
            assert torch.equal(a, b)


def test_static_operators_loaded_twice_are_fresh_ones(data):
    """The static rectangular spline operator and a static segment sum
    over the real entries, loaded with the batches with the most and the
    fewest real edges in turn (spare slots spoiled with out-of-range
    columns), give bitwise a freshly built operator's forward and
    gradient."""
    loader, _ = _loaders(data, "graclus")
    batches = sorted(loader, key=lambda b: -int(b.edge_mask.sum()))
    n, e = loader.num_nodes, loader.num_edges
    spline = static_spline_operator(n, e, 2, 5, device="cpu")
    segment = StaticSegmentSum(n, e, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for graph in (batches[0], batches[-1]):
        fresh = spline_operator(graph, 2, 5, device="cpu")
        spline.load(fresh)
        for csr in (spline.geom.fwd, spline.geom.bwd):
            csr.col[real_entries(csr):] = csr.num_cols + 1000
        fresh_seg = SortedSegmentSum(graph.receivers, n,
                                     entry_mask=graph.edge_mask,
                                     device="cpu")
        segment.load(fresh_seg)
        segment.csr.col[real_entries(segment.csr):] = n + 1000
        x = torch.randn(n, 3, generator=gen)
        msgs = torch.randn(e, 3, generator=gen) * graph.edge_mask[:, None]
        for ops, arg, gshape in (((spline, fresh), x, (n * 25, 3)),
                                 ((segment, fresh_seg), msgs, (n, 3))):
            gout = torch.randn(gshape, generator=gen)
            outs = []
            for op in ops:
                t = arg.clone().requires_grad_()
                out = op(t)
                out.backward(gout)
                outs.append((out, t.grad))
            for a, b in zip(*outs):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (d) what the static path refuses
# ---------------------------------------------------------------------------

def test_capture_needs_a_card_one_static_shape_and_a_fit(data):
    loaders = _loaders(data, "graclus")
    for module in EXAMPLES.values():
        with pytest.raises(ValueError,
                           match="capture=True needs a CUDA device"):
            module.run(1, device="cpu", capture=True, loaders=loaders)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cap.CapturedStep(lambda: None, torch.device("cpu"), generator=gen)
    train, _ = loaders
    train.dynamic_buckets = True
    try:
        with pytest.raises(ValueError, match="dynamic_buckets"):
            mnist_graclus.static_batch(train, "cpu")
    finally:
        train.dynamic_buckets = False
    g = next(iter(train))
    n = train.num_nodes
    small = static_spline_operator(n, 8, 2, 5, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        small.load(spline_operator(g, 2, 5, device="cpu"))
    other = static_spline_operator(n + 1, train.num_edges, 2, 5,
                                   device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        other.load(spline_operator(g, 2, 5, device="cpu"))
    seg = StaticSegmentSum(n, n, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        seg.load(pool_operator(g, device="cpu"))
    static = mnist_graclus.static_batch(train, "cpu")
    with pytest.raises(ValueError, match="operators"):
        static.load(g, mnist_graclus.mnist_operators(g, segment_ops=True))
    build = functools.partial(mnist_graclus.mnist_operators, host={})
    assert set(build(g)) == set(static.ops)
