"""The training run as one captured CUDA graph (``models/capture.py``),
the port's counterpart of the JAX trainers' one-program ``lax.scan`` run.

On the CPU: ``capture=True`` raises, ``capture=None`` is the eager run,
and the run with the device epoch buffer and counter gives the same curve
and parameters, bit for bit, as a plain loop of ``epoch_step`` calls
stacked at the end, for every backend of the three trainers and every
model of the citation suite.

On the card (marker ``cuda``; these tests import no JAX, so they also run
with ``python -m pytest --noconftest tests/test_torch_port_capture.py -m
cuda``): five captured epochs against five eager ones from the same seeds
(logits and every parameter within 1e-6 of the largest magnitude) for
every backend, the eager run's launch counts, the captured run's launches
by stage, and no host synchronisation between replays.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.datasets import Entities
from pytorch_geometric_tpu_torch.examples import citation_suite as suite
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.models import entities as tent
from pytorch_geometric_tpu_torch.transforms import TargetIndegree

CLASSES = 4
#: (trainer, backend or suite model) of every configuration the trainers
#: take.
CONFIGS = [("gcn", b) for b in ("packed", "sorted", "fused", "dense",
                                 "hybrid")] + [
    ("gat", b) for b in ("packed", "dense", "bsr")] + [("rgcn", None)] + [
    ("suite", m) for m in ("sgc", "agnn", "arma", "spline", "dna")] + [
    ("gcn_closure", "packed"), ("gat_closure", "packed"),
    ("rgcn_closure", None)]


def _base(kind):
    """``(trainer, closure)`` of a configuration's kind: the ``_closure``
    kinds train on the training nodes' closure (``closure=True``)."""
    base, _, closure = kind.partition("_")
    return base, closure == "closure"


def _citation(seed=0, n=150, e=600, f=24):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-8, 9, e), 0, n - 1)
    ei = np.unique(np.stack([src, dst]), axis=1)
    return Data(x=rng.random((n, f)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, CLASSES, n), train_mask=rng.random(n) < 0.4,
                val_mask=rng.random(n) < 0.3, test_mask=rng.random(n) < 0.3)


def _graph(kind, device, tmp_path, backend=None):
    if _base(kind)[0] == "rgcn":
        return from_data(Entities(str(tmp_path), "MUTAG", scale=0.01)[0],
                         device=device)
    if backend == "spline":
        return from_data(TargetIndegree()(_citation()), device=device)
    return from_data(_citation(), device=device)


def _train(kind, backend, graph, epochs, device, capture=None, seed=3):
    kind, closure = _base(kind)
    if kind == "suite":
        return suite.train_suite(backend, graph, CLASSES, epochs=epochs,
                                 seed=seed, device=device, capture=capture)
    if kind == "gcn":
        return tcit.train_gcn(graph, CLASSES, epochs=epochs, seed=seed,
                              device=device, backend=backend,
                              capture=capture, closure=closure)
    if kind == "gat":
        return tcit.train_gat(graph, CLASSES, epochs=epochs, seed=seed,
                              device=device, backend=backend,
                              capture=capture, closure=closure)
    return tent.train_rgcn(graph, 46, 2, epochs=epochs, seed=seed,
                           device=device, capture=capture, closure=closure)


def _loop_of_plain_steps(kind, backend, graph, epochs, seed=3):
    """The model, curve and evaluation of ``epochs`` calls of the
    trainer's ``epoch_step`` from a Python loop, the outputs stacked at
    the end: the trainers' eager loop before the epoch buffer."""
    dev = graph.device
    init = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kind, closure = _base(kind)
    if kind == "gcn":
        model = tcit.GCN(graph.num_node_features, 16, CLASSES,
                         generator=init).to(dev)
        step, eval_fn = tcit.create_gcn_train_step(
            model, graph, backend=backend, closure=closure)
    elif kind == "gat":
        model = tcit.GAT(graph.num_node_features, CLASSES,
                         generator=init).to(dev)
        step, eval_fn = tcit.create_gat_train_step(
            model, graph, backend=backend, closure=closure)
    elif kind == "suite":
        cls, hp = suite.MODELS[backend]
        model = cls(graph.num_node_features, CLASSES, generator=init).to(dev)
        step, eval_fn = suite.create_train_step(
            model, graph, hp["lr"], hp["wd"], cls.operators(graph))
    else:
        model = tent.RGCN(graph.num_nodes, 46, 2, generator=init).to(dev)
        step, eval_fn = tent.create_rgcn_train_step(model, graph, 46,
                                                    closure=closure)
        gen = None
    outs = [step(gen) for _ in range(epochs)]
    curve = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
             for k in ("loss", "train_acc")}
    return model, curve, {k: float(v) for k, v in eval_fn().items()}


def _logits(kind, backend, model, graph):
    """The trained model's logits through the run's fused operators,
    dropout off (a closure run's on the full graph, as it evaluates)."""
    kind = _base(kind)[0]
    with torch.no_grad():
        if kind == "suite":
            return model(graph, graph.x, **model.operators(graph))
        if kind == "gcn":
            agg = tcit.gcn_backend(graph, backend, 16, CLASSES)[0]
            return model(graph, graph.x, **agg)
        if kind == "gat":
            return model(graph, graph.x,
                         flash_op=tcit.gat_flash_op(graph, backend))
        return model(graph, fused_ops=tent.rgcn_fused_ops(graph, 46))


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("kind", ["gcn", "gat", "rgcn"])
def test_capture_true_on_the_cpu_raises(kind, tmp_path):
    graph = _graph(kind, "cpu", tmp_path)
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        _train(kind, "packed", graph, 1, "cpu", capture=True)


def test_resolve_capture():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert cap.resolve_capture(None, cpu) is False
    assert cap.resolve_capture(None, cuda) is True
    assert cap.resolve_capture(False, cuda) is False
    assert cap.resolve_capture(True, cuda) is True
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cap.resolve_capture(True, cpu)


def test_device_launches_counts_replays_warm_up_and_evaluation():
    launches = {"warm_up": {"spmm_csr": 4}, "captured_epoch": {"spmm_csr": 4},
                "replays": 199, "evaluation": {"spmm_csr": 2}}
    assert cap.device_launches(launches) == {"spmm_csr": 802}
    launches = {"warm_up": {"fused_gcn_fwd": 1, "fused_gcn_bwd": 1},
                "captured_epoch": {"fused_gcn_fwd": 1, "fused_gcn_bwd": 1},
                "replays": 199, "evaluation": {"spmm_csr": 2}}
    assert cap.device_launches(launches) == {
        "fused_gcn_bwd": 200, "fused_gcn_fwd": 200, "spmm_csr": 2}
    assert set(cap.launch_counts()) == {w.__name__
                                        for w in cap.COUNTED_WRAPPERS}


@pytest.mark.parametrize("kind,backend", CONFIGS)
def test_epoch_buffer_run_equals_the_plain_loop_on_the_cpu(kind, backend,
                                                           tmp_path):
    """``capture=None`` on the CPU runs eagerly, and its device buffer and
    counter give the plain loop's curve, evaluation and parameters bit for
    bit; the metric keys are the eager run's."""
    graph = _graph(kind, "cpu", tmp_path, backend)
    model, metrics = _train(kind, backend, graph, 4, "cpu")
    ref_model, curve, final = _loop_of_plain_steps(kind, backend, graph, 4)
    accs = sorted(final)
    setup = ["setup_launches", "setup_seconds"] if kind == "suite" else []
    assert sorted(metrics) == sorted(["curve", "seconds"] + accs + setup)
    for k in ("loss", "train_acc"):
        assert metrics["curve"][k].shape == (4,)
        np.testing.assert_array_equal(metrics["curve"][k], curve[k])
    assert {k: metrics[k] for k in accs} == final
    ref = dict(ref_model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, ref[name]), name


def test_no_epochs_gives_an_empty_curve_and_no_capture_at_zero(tmp_path):
    graph = _graph("gcn", "cpu", tmp_path)
    _, metrics = _train("gcn", "packed", graph, 0, "cpu", capture=False)
    assert metrics["curve"] == {}
    with pytest.raises(ValueError, match="at least one epoch"):
        cap.run_epochs(None, None, 0, None, torch.device("cpu"),
                       capture=True)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph holds device work "
                    "only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: Launches per eager epoch and of the evaluation, by wrapper, on each
#: configuration's CUDA graph.
EAGER_LAUNCHES = {
    ("gcn", "packed"): ({"spmm_csr": 4}, {"spmm_csr": 2}),
    ("gcn", "sorted"): ({"sorted_segment_sum": 4},
                        {"sorted_segment_sum": 2}),
    ("gcn", "fused"): ({"fused_gcn_fwd": 2, "fused_gcn_bwd": 2},
                       {"spmm_csr": 2}),
    ("gcn", "dense"): ({}, {}),
    # one window of 512 holds the 150 nodes: every edge dense, one part
    ("gcn", "hybrid"): ({"spmm_csr": 4}, {"spmm_csr": 2}),
    ("gat", "packed"): ({"packed_gat_fwd": 2, "packed_gat_bwd": 4},
                        {"packed_gat_fwd": 2}),
    ("gat", "dense"): ({"flash_gat_fwd": 2, "flash_gat_bwd": 4},
                       {"flash_gat_fwd": 2}),
    ("gat", "bsr"): ({"bsr_gat_fwd": 2, "bsr_gat_bwd_row": 2,
                      "bsr_gat_bwd_col": 2}, {"bsr_gat_fwd": 2}),
    ("rgcn", None): ({"packed_rgcn_fwd": 4, "packed_rgcn_bwd": 6},
                       {"packed_rgcn_fwd": 4}),
    ("suite", "sgc"): ({}, {}),
    ("suite", "agnn"): ({"spmm_csr": 4, "sorted_segment_sum": 8},
                        {"spmm_csr": 2, "sorted_segment_sum": 2}),
    ("suite", "arma"): ({"spmm_csr": 8}, {"spmm_csr": 4}),
    ("suite", "spline"): ({"spmm_csr": 6}, {"spmm_csr": 4}),
    ("suite", "dna"): ({"sorted_segment_sum": 12}, {"sorted_segment_sum": 4}),
    # the closure runs: the full graph's counts, over the closure's layers
    ("gcn_closure", "packed"): ({"spmm_csr": 4}, {"spmm_csr": 2}),
    ("gat_closure", "packed"): ({"packed_gat_fwd": 2, "packed_gat_bwd": 4},
                                {"packed_gat_fwd": 2}),
    ("rgcn_closure", None): ({"packed_rgcn_fwd": 4, "packed_rgcn_bwd": 6},
                             {"packed_rgcn_fwd": 4}),
}
#: Launches at set-up (a suite model's operators): SGC's propagation.
SETUP_LAUNCHES = {("suite", "sgc"): {"spmm_csr": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,backend", CONFIGS)
def test_captured_run_matches_eager_on_card(kind, backend, cuda_device,
                                            tmp_path):
    """Five captured epochs against five eager ones from the same seeds:
    curve, logits and every parameter within 1e-6 of the largest
    magnitude; the eager run counts its launches as before, the captured
    one by stage."""
    graph = _graph(kind, cuda_device, tmp_path, backend)
    epochs = 5
    per_epoch, evaluation = EAGER_LAUNCHES[(kind, backend)]
    setup = SETUP_LAUNCHES.get((kind, backend), {})
    before = cap.launch_counts()
    eager_model, eager = _train(kind, backend, graph, epochs, cuda_device,
                                capture=False)
    counted = {k: v - before[k] for k, v in cap.launch_counts().items()
               if v != before[k]}
    assert counted == {k: epochs * per_epoch.get(k, 0) + evaluation.get(k, 0)
                       + setup.get(k, 0)
                       for k in set(per_epoch) | set(evaluation) | set(setup)}
    assert "launches" not in eager and "capture_seconds" not in eager
    model, captured = _train(kind, backend, graph, epochs, cuda_device)
    assert captured["launches"] == {"warm_up": per_epoch,
                                    "captured_epoch": per_epoch,
                                    "replays": epochs - 1,
                                    "evaluation": evaluation}
    assert captured["capture_seconds"] > 0
    for k in ("loss", "train_acc"):
        np.testing.assert_allclose(
            captured["curve"][k], eager["curve"][k], rtol=0,
            atol=1e-6 * np.abs(eager["curve"][k]).max())
    assert _rel_err(_logits(kind, backend, model, graph),
                    _logits(kind, backend, eager_model, graph)) <= 1e-6
    ref = dict(eager_model.named_parameters())
    for name, p in model.named_parameters():
        assert _rel_err(p.detach(), ref[name].detach()) <= 1e-6, name


@pytest.mark.cuda
def test_replays_make_no_host_synchronisation(cuda_device):
    """Between replays nothing waits on the card: the sync debug mode
    raises on any synchronising call."""
    graph = _graph("gat", cuda_device, None)
    model = tcit.GAT(graph.num_node_features, CLASSES,
                     generator=torch.Generator().manual_seed(0)).to(
                         cuda_device)
    step, _ = tcit.create_gat_train_step(model, graph)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cap.warm_up(lambda: step(gen), cuda_device)
    cuda_graph = cap.capture_epoch(lambda: step(gen), gen, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            cuda_graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(p).all() for p in model.parameters())
