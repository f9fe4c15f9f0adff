"""reddit_sage's steps over static buffers: the port's counterpart of
examples/reddit_sage.py's jitted ``train_step`` and ``eval_step``, which a
card captures once in a CUDA graph over the sampler's budgets and replays
for every batch (``examples/reddit_sage.py:StaticSampled``), each batch's
neighbour-sum operator built on the host by the sampler
(``NeighborSampler.iter_host``).

On the CPU, through the kernel's plain version, on a synthetic graph of
400 nodes and 3,200 edges, batches of 16 seeds:

- one SGD step of the port's ``SAGE`` over the static buffers (which
  held another batch first) against the JAX script's model and loss on
  the same sampled batch (the two samplers draw alike), from the same
  parameters (numpy draws in the flax model's tree): the loss within
  1e-5 and the parameters after the step within 1e-5 of the largest
  parameter magnitude;
- the static buffers loaded with two batches of different real sizes in
  turn, the operator's spare slots spoiled, give bitwise each batch's own
  tensors' and operator's logits and gradients;
- the run through the static buffers with the capture left out
  (``CapturedStep(capture=False)``) bitwise the eager run: every step's
  loss, the accuracy and the final parameters;
- with ``prefetch``, the producer thread builds each batch's operator on
  the host, and an epoch's batches and operators are the inline
  sampler's, bitwise;
- a packed batch of another sampler's budgets does not fit, and
  ``run(capture=True)`` on the CPU raises.

The card's checks (captured against eager bitwise, 5 ``spmm_csr`` launches
a step and 4 an evaluation batch by stage) are ``chip_smoke.py``'s
``slice_reddit_sage``.
"""

import importlib.util
import itertools
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data.neighbor_loader import (
    NeighborSampler as JNeighborSampler)
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.examples import reddit_sage
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.ops.csr import real_entries
from test_torch_port_static_faust_points import numpy_params

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
CPU = torch.device("cpu")


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


def _corpus(seed=0, n=400, e=3200, f=24, c=5):
    """A Reddit-shaped corpus in miniature: features, labels, and the
    train / val split masks."""
    rng = np.random.default_rng(seed)
    split = rng.random(n)
    return Data(x=rng.normal(size=(n, f)).astype(np.float32),
                edge_index=np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
                y=rng.integers(0, c, n), train_mask=split < 0.66,
                val_mask=(split >= 0.66) & (split < 0.76))


def _spoil(static):
    """Out-of-range columns in every slot past each CSR's real entries."""
    geom = static.ops["aggregate"].geom
    for csr in (geom.fwd, geom.bwd):
        csr.col[real_entries(csr):] = csr.num_cols + 1000


def _pass(model, graph, aggregate, x_dev):
    model.zero_grad(set_to_none=True)
    logits = model(graph, x_dev[graph.extras["local_to_global"].long()],
                   aggregate)
    logits.backward(torch.linspace(-1, 1, logits.numel()).reshape(
        logits.shape))
    return [logits.detach()] + [p.grad.clone() for p in model.parameters()]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "reference_examples_reddit_sage",
        REPO / "examples" / "reddit_sage.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_one_static_step_matches_the_jax_step():
    data = _corpus(1)
    ei = data.edge_index
    train, _, x_dev, y_dev = reddit_sage.loaders(data, batch_size=16,
                                                 device="cpu")
    jtrain = JNeighborSampler(ei[0], ei[1], data.num_nodes, sizes=[10, 10],
                              batch_size=16,
                              seed_nodes=np.flatnonzero(data.train_mask),
                              seed=0, materialize_features=False)
    jx, jy = jtrain.device_tables(data.x, data.y.astype(np.int32))
    (g, op), (other, other_op) = itertools.islice(train.iter_host(
        lambda b: reddit_sage.sage_aggregate(b, "cpu")), 2)
    jg = next(iter(jtrain))
    jmodel = _jax_script().SAGE(hidden=128, num_classes=5)
    params = numpy_params(jmodel.init, jax.random.PRNGKey(0), jg,
                          jnp.take(jx, jg.extras["local_to_global"], axis=0))
    model = reddit_sage.SAGE(24, 128, 5)
    model.load_state_dict(params_from_jax(params))
    static = reddit_sage.StaticSampled(train, CPU)
    for batch, aggregate in ((other, other_op), (g, op)):
        static.load(batch, {"aggregate": aggregate})
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    loss = reddit_sage.train_step(model, opt, static.graph, x_dev, y_dev,
                                  static.ops["aggregate"])

    def loss_fn(p, graph):
        ids = graph.extras["local_to_global"]
        logp = jax.nn.log_softmax(jmodel.apply(p, graph,
                                               jnp.take(jx, ids, axis=0)))
        oh = jnp.take(jy, ids)[:, None] == jnp.arange(5)[None, :]
        nll = -jnp.sum(logp * oh.astype(logp.dtype), axis=1)
        m = graph.extras["seed_mask"].astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jg)
    params = jax.tree_util.tree_map(lambda p, d: p - 0.1 * d, params, grads)
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL)
    ref = params_from_jax(params)
    scale = max(float(v.abs().max()) for v in ref.values())
    for k, p in model.named_parameters():
        assert float((p.detach() - ref[k]).abs().max()) <= TOL * scale, k


def test_the_static_buffers_are_each_batchs_own():
    train, _, x_dev, _ = reddit_sage.loaders(_corpus(), batch_size=16,
                                             device="cpu")
    batches = list(itertools.islice(train.iter_host(
        lambda b: reddit_sage.sage_aggregate(b, "cpu")), 4))
    sizes = [int(g.node_mask.sum()) for g, _ in batches]
    assert len(set(sizes)) > 1
    model = reddit_sage.SAGE(24, 32, 5,
                             generator=torch.Generator().manual_seed(0))
    static = reddit_sage.StaticSampled(train, CPU)
    for graph, op in batches:
        static.load(graph, {"aggregate": op})
        _spoil(static)
        got = _pass(model, static.graph, static.ops["aggregate"], x_dev)
        want = _pass(model, graph, op, x_dev)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_the_static_run_is_the_eager_run_bitwise(monkeypatch):
    kw = dict(epochs=2, batch_size=16, max_batches=3, device="cpu",
              data=_corpus())
    eager = reddit_sage.run(capture=False, **kw)
    monkeypatch.setattr(reddit_sage, "resolve_capture",
                        lambda capture, dev: True)
    monkeypatch.setattr(cap, "CapturedStep", _Uncaptured)
    static = reddit_sage.run(**kw)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    assert static["step_losses"].shape == (2, 3)
    assert static["acc"] == eager["acc"]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    # three train batches and one val batch (max_batches // 2) an epoch
    assert static["host_batches"] == eager["host_batches"] == 2 * (3 + 1)
    assert static["device_launches"] == {}
    assert sorted(static["launches"]) == ["evaluation", "train"]


def test_the_producer_thread_builds_the_operators():
    """A whole epoch of ``iter_host`` with ``prefetch=2``: the batches and
    operators of the inline sampler, bitwise, each operator built in the
    producer thread (an epoch abandoned early leaves the producer's draws
    ahead, so the runs compare inline sampling)."""
    data = _corpus()
    epochs, threads = [], []
    for prefetch in (0, 2):
        train, _, _, _ = reddit_sage.loaders(data, batch_size=16,
                                             prefetch=prefetch,
                                             device="cpu")

        def build(graph):
            threads.append(threading.current_thread().name)
            return reddit_sage.sage_aggregate(graph, "cpu")

        epochs.append(list(train.iter_host(build)))
    inline, piped = epochs
    assert len(inline) == len(piped) == len(train) > 3
    main = threading.current_thread().name
    assert threads == [main] * len(train) + \
        ["neighbor-sampler-prefetch"] * len(train)
    for (g, op), (h, oq) in zip(inline, piped):
        assert np.array_equal(train.pack_batch(g), train.pack_batch(h))
        for a, b in ((op.geom.fwd, oq.geom.fwd), (op.geom.bwd, oq.geom.bwd)):
            for f in ("row_ptr", "col", "perm"):
                assert torch.equal(getattr(a, f), getattr(b, f))
        assert op.consts["fwd"].device.type == "cpu"


def test_a_batch_of_other_budgets_does_not_fit():
    data = _corpus()
    train, _, _, _ = reddit_sage.loaders(data, batch_size=16, device="cpu")
    wide, _, _, _ = reddit_sage.loaders(data, batch_size=32, device="cpu")
    graph, op = next(iter(wide.iter_host(
        lambda b: reddit_sage.sage_aggregate(b, "cpu"))))
    with pytest.raises(ValueError, match="does not fit static buffers"):
        reddit_sage.StaticSampled(train, CPU).load(graph,
                                                  {"aggregate": op})


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        reddit_sage.run(1, batch_size=16, max_batches=1, device="cpu",
                        data=_corpus(), capture=True)
