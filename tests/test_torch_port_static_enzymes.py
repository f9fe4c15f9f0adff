"""The ENZYMES examples' steps over static buffers: the port's counterpart
of examples/enzymes_topk_pool.py's and enzymes_diff_pool.py's jitted
training and evaluation steps, which a card captures once in a CUDA graph
(``models/capture.py:CapturedStep``; DiffPool one a batch size) and
replays for every batch.

On the CPU, through the kernels' plain versions:

- the TopK net over the static batch (``mutag_gin.static_batch``: the
  graph, a ``StaticSpmmOperator`` and the readout's ``StaticSegmentSum``,
  loaded with two batches of different real sizes in turn, the spare
  slots filled with out-of-range columns) gives bitwise each batch's own
  operators' pooled masks, gated rows and scores on all three TopK
  levels, its logits and every gradient: no level needs an operator or a
  host step of its own;
- DiffPool's loader of 10 graphs in batches of 4 runs a step for sizes 4
  and 2 (``SizedStep``), never a padded batch: each step's mean loss and
  the parameters after its SGD step match the JAX script's ``train_step``
  on the same batches from the same flax parameters (1e-5; SGD, as the
  three-step parity of ``tests/test_torch_port_graph_examples.py``);
- each example's run through its static buffers, with the capture left
  out (``CapturedStep(capture=False)``), bitwise the eager run: every
  step's loss, the accuracy and the final parameters;
- ``run(capture=True)`` on the CPU raises.

The card's checks (captured against eager bitwise, launches by stage)
are ``chip_smoke.py``'s ``slice_topk`` and ``slice_diff_pool``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import DenseDataLoader as JDenseDataLoader
from pytorch_geometric_tpu.datasets import TUDataset as JTUDataset
from pytorch_geometric_tpu.transforms import ToDense as JToDense
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import DataLoader, DenseDataLoader
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.examples import (
    enzymes_diff_pool, enzymes_topk_pool, mutag_gin)
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.ops.csr import real_entries
from pytorch_geometric_tpu_torch.transforms import ToDense

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EXAMPLES = {"topk": enzymes_topk_pool, "diff_pool": enzymes_diff_pool}


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


def _spoil(csr):
    """Out-of-range columns in every slot past the CSR's real entries."""
    csr.col[real_entries(csr):] = csr.num_cols + 1000


def _topk_pass(net, graph, ops):
    """The net's pooled masks, gated rows and scores at each level, its
    logits and its gradients, one backward of a fixed cotangent."""
    levels = []
    hooks = [getattr(net, f"pool{i}").register_forward_hook(
        lambda m, args, out: levels.append(
            (out[0].node_mask, out[0].edge_mask, out[1], out[2])))
        for i in (1, 2, 3)]
    net.zero_grad(set_to_none=True)
    logits = net(graph, train=False, **ops)
    logits.backward(torch.linspace(-1, 1, logits.numel()).reshape(
        logits.shape))
    for h in hooks:
        h.remove()
    grads = [p.grad.clone() for p in net.parameters()]
    return [t for level in levels for t in level] + [logits.detach()] + grads


def test_the_static_batch_is_each_batchs_own_operators_on_every_level(
        tmp_path):
    loader = DataLoader(TUDataset(str(tmp_path), "ENZYMES")[:24],
                        batch_size=8, device="cpu")
    batches = sorted(loader, key=lambda g: -int(g.edge_mask.sum()))
    big, small = batches[0], batches[-1]
    assert int(big.edge_mask.sum()) > int(small.edge_mask.sum())
    net = enzymes_topk_pool.Net(3, 6, hidden=16,
                                generator=torch.Generator().manual_seed(0))
    static = mutag_gin.static_batch(loader, "cpu")
    for graph in (big, small):
        ops = mutag_gin.mutag_operators(graph)
        static.load(graph, ops)
        for csr in (static.ops["spmm_op"].fwd, static.ops["spmm_op"].bwd,
                    static.ops["pool_op"].csr):
            _spoil(csr)
        got = _topk_pass(net, static.graph, static.ops)
        want = _topk_pass(net, graph, ops)
        assert len(got) == len(want) == 3 * 4 + 1 + len(list(
            net.parameters()))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        # the pools keep fewer nodes at each level
        kept = [int(got[4 * i].sum()) for i in range(3)]
        assert kept[0] > kept[1] > kept[2] > 0


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dense_loaders(tmp_path, count=10):
    """The port's and the JAX package's dense loaders over the same
    synthetic ENZYMES graphs of at most 126 nodes, batches of 4."""
    raw = tmp_path / "jax" / "ENZYMES" / "raw"
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")
    n = enzymes_diff_pool.MAX_NODES
    port = [ToDense(n)(d) for d in
            TUDataset(str(tmp_path / "port"), "ENZYMES")[:2 * count]
            if d.num_nodes <= n][:count]
    ref = [JToDense(n)(d) for d in
           JTUDataset(str(tmp_path / "jax"), "ENZYMES")[:2 * count]
           if d.num_nodes <= n][:count]
    assert len(port) == len(ref) == count
    return (DenseDataLoader(port, batch_size=4, shuffle=True, seed=0,
                            device="cpu"),
            JDenseDataLoader(ref, batch_size=4, shuffle=True, seed=0))


def test_diff_pool_runs_a_step_a_batch_size_as_the_jax_step(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(enzymes_diff_pool, "CapturedStep", _Uncaptured)
    jmod = _jax_example("enzymes_diff_pool")
    loader, jloader = _dense_loaders(tmp_path)
    jnet = jmod.DiffPoolNet(num_classes=6, hidden=16)
    b0 = next(iter(jloader))
    params = jnet.init(jax.random.PRNGKey(2), b0.x, b0.adj, b0.mask)
    next(iter(loader))
    net = enzymes_diff_pool.DiffPoolNet(3, 6, hidden=16)
    net.load_state_dict(params_from_jax(params))
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    host = {}
    step = enzymes_diff_pool.SizedStep(
        lambda b: enzymes_diff_pool.train_step(net, opt, b), CPU, host)

    def loss_fn(p, x, adj, mask, y):
        logits, ll, el = jnet.apply(p, x, adj, mask)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, y.astype(jnp.int32)[:, None], axis=1).mean()
        return nll + ll + el

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    sizes = []
    for b, jb in zip(loader.batches("cpu"), jloader, strict=True):
        loss = step(b)
        want, grads = value_and_grad(params, jb.x, jb.adj, jb.mask, jb.y)
        params = jax.tree_util.tree_map(lambda p, d: p - 0.1 * d, params,
                                        grads)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
        sizes.append(b.num_graphs)
    assert sizes == [4, 4, 2] and sorted(step.steps) == [2, 4]
    assert step.buffers[2]["adj"].shape == (2, 126, 126)
    assert host["batches"] == 3
    want = params_from_jax(params)
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 1e-5 * scale


def _loaders_of(name, tmp_path):
    if name == "topk":
        ds = TUDataset(str(tmp_path), "ENZYMES")
        return (DataLoader(ds[:20], batch_size=8, shuffle=True, seed=0,
                           device="cpu"),
                DataLoader(ds[20:26], batch_size=8, device="cpu"))
    train, test = _dense_loaders(tmp_path, 14)[0], None
    test = DenseDataLoader(train.dataset[10:], batch_size=3, device="cpu")
    train.dataset = train.dataset[:10]
    return train, test


@pytest.mark.parametrize("name", ["topk", "diff_pool"])
def test_the_static_run_is_the_eager_run_bitwise(tmp_path, monkeypatch,
                                                  name):
    module = EXAMPLES[name]
    eager = module.run(2, device="cpu", capture=False,
                       loaders=_loaders_of(name, tmp_path / "a"))
    monkeypatch.setattr(module, "resolve_capture", lambda capture, dev: True)
    monkeypatch.setattr(module, "CapturedStep", _Uncaptured)
    loaders = _loaders_of(name, tmp_path / "b")
    static = module.run(2, device="cpu", loaders=loaders)
    assert np.array_equal(static["step_losses"], eager["step_losses"])
    assert static["acc"] == eager["acc"]
    final = dict(eager["model"].named_parameters())
    for k, p in static["model"].named_parameters():
        assert torch.equal(p, final[k]), k
    assert static["host_batches"] == 2 * (len(loaders[0]) + len(loaders[1]))
    assert static["device_launches"] == {}
    if name == "diff_pool":
        # the last train batch (2 of 10) and the test batch (1 of 4)
        # have steps of their own
        assert sorted(static["launches"]) == [
            "evaluation_1", "evaluation_3", "train_2", "train_4"]


@pytest.mark.parametrize("name", ["topk", "diff_pool"])
def test_capture_needs_a_card(tmp_path, name):
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        EXAMPLES[name].run(1, device="cpu", capture=True,
                           loaders=_loaders_of(name, tmp_path))
