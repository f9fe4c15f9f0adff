"""The research driver's inductive phases over static buffers: the port's
counterpart of pytorch_geometric_tpu/research/driver.py's jitted
``train_part_graphcls`` step and evaluation and ``training_net_ppi``'s
``fit``, which a card captures once in a CUDA graph over the loader's
budget and replays for every batch (``models/capture.py:StepLoop``,
``research/driver.py:static_pair``).

On the CPU, through the kernels' plain versions, at a small size
(ENZYMES cut to 40 graphs in batches of 8, two epochs a phase; PPI to 4
train graphs and 2 test graphs in batches of 2, one epoch a phase; a few
random graphs):

- PrunableTopK's operators over the batch's real edges give its logits
  and every gradient bitwise the padded operator's (the padding edges
  weigh 0 at every level);
- one SGD step of PrunableTopK and of PrunableGCN over static buffers
  (which held another batch first) against the JAX model and the JAX
  driver's loss on the same numpy-seeded batch, from the same parameters
  (numpy draws in the flax model's tree), dropout off: the loss within
  1e-5 and the parameters after the step within 1e-5 of the largest
  parameter magnitude;
- each static form (TopK's, GCN's), loaded with two batches of different
  real sizes in turn, its spare slots spoiled, gives bitwise each
  batch's own operators' logits and gradients; the other zoo models
  have none and run eagerly under ``capture=None``;
- ``training_net_graphcls`` and ``training_net_ppi`` through their static
  buffers with the capture left out (``CapturedStep(capture=False)``),
  dropout on, bitwise their eager runs: both phases' every step's loss,
  test curves and final parameters;
- ``capture=True`` on the CPU raises, and so it does for a model without
  static forms and for the data-parallel phases.

The card's checks (captured against eager bitwise, the launches by
stage) are ``chip_smoke.py``'s ``slice_driver_inductive``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data.batch import collate as j_collate
from pytorch_geometric_tpu.models import prunable as jprunable
from pytorch_geometric_tpu.models.citation import softmax_xent_int_labels
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, DataLoader
from pytorch_geometric_tpu_torch.datasets import PPI, TUDataset
from pytorch_geometric_tpu_torch.examples.ppi import bce_loss
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.models import prunable
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.pool import pool_operator
from pytorch_geometric_tpu_torch.ops.csr import StaticCsr, real_entries
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator
from pytorch_geometric_tpu_torch.research import driver
from test_torch_port_static_faust_points import numpy_params

TOL = 1e-5
F_IN, CLASSES = 10, 3
WIDTHS = (9, 6)


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
    buffers' path of a captured phase on the CPU."""

    def __init__(self, body, dev, capture=True, generator=None):
        super().__init__(body, dev, capture=False)


def _spoil(ops):
    """Out-of-range columns in every slot past each static CSR's real
    entries."""
    for op in ops.values():
        for csr in vars(getattr(op, "geom", op)).values():
            if isinstance(csr, StaticCsr):
                csr.col[real_entries(csr):] = csr.num_cols + 1000


def _pass(model, graph, ops):
    """The model's logits and its gradients, one backward of a fixed
    cotangent, dropout off."""
    model.zero_grad(set_to_none=True)
    args = () if isinstance(model, prunable.PrunableTopK) else (graph.x,)
    logits = model(graph, *args, **ops)
    logits.backward(torch.linspace(-1, 1, logits.numel()).reshape(
        logits.shape))
    return [logits.detach()] + [p.grad.clone() for p in model.parameters()]


def _graph_arrays(seed, count, multilabel):
    """Random graphs of 5-12 nodes, undirected edges, ``F_IN`` features;
    a class a graph, or ``CLASSES`` binary labels a node."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 12))
        ei = np.stack([rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)])
        y = (rng.random((n, CLASSES)) < 0.3).astype(np.float32) \
            if multilabel else np.int64(rng.integers(0, CLASSES))
        out.append(dict(x=rng.normal(size=(n, F_IN)).astype(np.float32),
                        edge_index=np.concatenate([ei, ei[::-1]], 1), y=y))
    return out


def _model(name):
    kw = {} if name == "TopK" else {"dropout": 0.0}
    return prunable.choose_model(
        name, WIDTHS, CLASSES, in_channels=F_IN,
        generator=torch.Generator().manual_seed(0), **kw)


def test_topk_real_edge_operators_are_the_padded_ones_bitwise(tmp_path):
    loader = DataLoader(TUDataset(str(tmp_path), "ENZYMES")[:16],
                        batch_size=8, device="cpu")
    model = prunable.PrunableTopK((16, 12), 6, in_channels=3,
                                  generator=torch.Generator().manual_seed(0))
    for graph in loader:
        ops = model.operators(graph)
        assert ops["spmm_op"].fwd.num_edges == int(graph.edge_mask.sum()) \
            < graph.num_edges
        padded = {"spmm_op": SpmmOperator(graph.senders, graph.receivers,
                                          graph.num_nodes, device="cpu"),
                  "pool_op": pool_operator(graph)}
        for a, b in zip(_pass(model, graph, ops),
                        _pass(model, graph, padded)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# One static step against the JAX step
# ---------------------------------------------------------------------------

def _jax_loss(name, jmodel):
    def loss_fn(p, graph):
        if name == "TopK":
            logits = jmodel.apply(p, graph)
            nll = softmax_xent_int_labels(logits, graph.y)
            m = graph.graph_mask.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)
        logits = jmodel.apply(p, graph, graph.x)
        y = graph.y.astype(jnp.float32)
        per = optax.sigmoid_binary_cross_entropy(logits, y)
        m = graph.real_node_mask().astype(jnp.float32)[:, None]
        return jnp.sum(per * m) / jnp.maximum(jnp.sum(m) * y.shape[1], 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("name", ["TopK", "GCN"])
def test_one_static_step_matches_the_jax_step(name):
    arrays = _graph_arrays(0, 6, multilabel=name == "GCN")
    loader = DataLoader([Data(**a) for a in arrays], batch_size=3,
                        device="cpu")
    first, other = list(loader)
    jg = j_collate([JData(**a) for a in arrays[:3]],
                   num_nodes=loader.num_nodes, num_edges=loader.num_edges,
                   num_graphs=loader.num_graphs)
    jmodel = jprunable.choose_model(
        name, WIDTHS, CLASSES, **({} if name == "TopK" else {"dropout": 0.0}))
    key = jax.random.PRNGKey(3)
    params = numpy_params(jmodel.init, {"params": key, "dropout": key},
                          *((jg,) if name == "TopK" else (jg, jg.x)))
    model = _model(name)
    model.load_state_dict(params_from_jax(params))
    static = driver.static_pair(model, (loader, loader), torch.device(
        "cpu"))[0]
    for graph in (other, first):
        static.load(graph, model.operators(graph))
    g = static.graph
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    if name == "TopK":
        loss = graph_xent_loss(model(g, **static.ops), g.y, g.graph_mask)
    else:
        loss = bce_loss(model(g, g.x, **static.ops), g)
    loss.backward()
    opt.step()
    want, grads = _jax_loss(name, jmodel)(params, jg)
    params = jax.tree_util.tree_map(lambda p, d: p - 0.1 * d, params, grads)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=TOL)
    ref = params_from_jax(params)
    scale = max(float(v.abs().max()) for v in ref.values())
    for k, p in model.named_parameters():
        assert float((p.detach() - ref[k]).abs().max()) <= TOL * scale, k


@pytest.mark.parametrize("name", ["TopK", "GCN"])
def test_static_forms_are_each_batchs_own_operators(name):
    arrays = _graph_arrays(1, 6, multilabel=name != "TopK")
    loader = DataLoader([Data(**a) for a in arrays], batch_size=4,
                        device="cpu")
    batches = list(loader)
    assert int(batches[0].node_mask.sum()) > int(batches[1].node_mask.sum())
    model = _model(name)
    static = driver.static_pair(model, (loader, loader), torch.device(
        "cpu"))[0]
    for graph in batches:
        ops = model.operators(graph)
        static.load(graph, ops)
        _spoil(static.ops)
        got = _pass(model, static.graph, static.ops)
        want = _pass(model, graph, ops)
        assert len(got) == len(want) == 1 + len(list(model.parameters()))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The pipelines: static against eager, and the switch
# ---------------------------------------------------------------------------

def _small_datasets(monkeypatch, root):
    """ENZYMES cut to 40 graphs, PPI to 4 train and 2 test graphs, each
    drawn once and served to every pipeline of the test."""
    enzymes = TUDataset(str(root), "ENZYMES")[:40]
    ppi = {split: PPI(str(root), split=split)[:count]
           for split, count in (("train", 4), ("test", 2))}
    monkeypatch.setattr(driver, "TUDataset", lambda root, name: enzymes)
    monkeypatch.setattr(driver, "PPI", lambda root, split: ppi[split])


#: Epochs a phase: PPI's steps take most of the file's time.
EPOCHS = {"graphcls": 2, "ppi": 1}
PIPELINES = {
    "graphcls": lambda root, **kw: driver.training_net_graphcls(
        "ENZYMES", num_layers=2, epochs=EPOCHS["graphcls"],
        fine_tune_epochs=EPOCHS["graphcls"], batch_size=8,
        results_dir=f"{root}/R", ckpt_dir=f"{root}/c", device="cpu",
        root=root, **kw),
    "ppi": lambda root, **kw: driver.training_net_ppi(
        epochs=EPOCHS["ppi"], fine_tune_epochs=EPOCHS["ppi"], batch_size=2,
        results_dir=f"{root}/R", ckpt_dir=f"{root}/c", device="cpu",
        root=root, **kw)}


@pytest.mark.parametrize("name", ["graphcls", "ppi"])
def test_the_static_pipeline_is_the_eager_one_bitwise(tmp_path, monkeypatch,
                                                       name):
    _small_datasets(monkeypatch, tmp_path / "data")
    (eager,) = PIPELINES[name](tmp_path / "a", capture=False)
    monkeypatch.setattr(driver, "inductive_capture",
                        lambda model, capture, dev: True)
    monkeypatch.setattr(cap, "CapturedStep", _Uncaptured)
    (static,) = PIPELINES[name](tmp_path / "b")
    assert static["new_widths"] == eager["new_widths"]
    for got, want in zip(static["phases"], eager["phases"], strict=True):
        assert np.array_equal(got.steps["step_losses"],
                              want.steps["step_losses"])
        assert got.test_convergence == want.test_convergence
        assert got.train_convergence == want.train_convergence
        assert got.params.keys() == want.params.keys()
        for k, v in got.params.items():
            assert torch.equal(v, want.params[k]), k
        epochs, batches = got.steps["step_losses"].shape
        assert epochs == EPOCHS[name]
        # each epoch's train batches and its one test batch
        assert got.steps["host_batches"] == epochs * (batches + 1)
        assert got.steps["device_launches"] == {}
        assert "host_batches" not in want.steps


@pytest.mark.parametrize("name", ["graphcls", "ppi"])
def test_capture_needs_a_card(tmp_path, monkeypatch, name):
    _small_datasets(monkeypatch, tmp_path / "data")
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        PIPELINES[name](tmp_path, capture=True)


@pytest.mark.parametrize("name", ["GAT", "Cheb", "AGNN", "Spline"])
def test_models_without_static_forms_run_eagerly(name):
    model = _model(name)
    assert not hasattr(model, "static_operators")
    assert driver.inductive_capture(model, None,
                                    torch.device("cuda")) is False
    with pytest.raises(ValueError, match="no static operator forms"):
        driver.inductive_capture(model, True, torch.device("cuda"))


def test_capture_needs_static_forms_and_one_device():
    cuda = torch.device("cuda")
    agnn = _model("AGNN")
    assert driver.inductive_capture(agnn, None, cuda) is False
    assert driver.inductive_capture(_model("GCN"), None, cuda) is True
    assert driver.inductive_capture(_model("GCN"), None,
                                    torch.device("cpu")) is False
    with pytest.raises(ValueError, match="no static operator forms"):
        driver.inductive_capture(agnn, True, cuda)
    with pytest.raises(ValueError, match="data-parallel phases run eagerly"):
        driver.training_net_graphcls("ENZYMES", num_devices=2, capture=True,
                                     device="cpu")
