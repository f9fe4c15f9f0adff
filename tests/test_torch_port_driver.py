"""Port parity, the convex-pruning driver: ``research/driver.py`` against
the JAX one.

- ``train_part``: three epochs of a ``PrunableGCN`` with dropout off,
  cut by one weight correction after epoch 2 (preferential attachment,
  so that it moves weights), against the JAX ``train_part`` from the
  same variables: the losses, the per-span test accuracies, the best
  validation accuracy and the parameters (1e-4), with the features
  scaled so that the global gradient norm passes 5 and the clip acts
  (the JAX gradient norm is checked), and without; the checkpoint per
  span;
- ``clip_by_global_norm`` against optax's above and below the norm;
- ``training_net`` on the CPU at two epochs a phase, on a small graph in
  place of Cora: the JAX widths, the pruned widths from the phase-1
  parameters, the files; ``resume``
  looks up the bare run key, as the JAX driver does, and so finds none
  of the ``-phase1`` / ``-phase2`` checkpoints; ``fused_gat=False``
  raises on a card (a meta tensor stands for it);
- ``training_net_ppi`` and ``training_net_graphcls`` one epoch a phase;
- the CLI's 20 flags read by AST against the JAX file, and the two
  flags that wait for later items (``--gpus > 1``, ``--partition``)
  raising with the item's number."""

import ast
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import prunable as jprunable
from pytorch_geometric_tpu.research import driver as jdriver
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models.prunable import choose_model
from pytorch_geometric_tpu_torch.research import driver
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager
from pytorch_geometric_tpu_torch.research.pruning import (
    contraction_layer_coefficients, retain_network_size)

REPO = Path(__file__).resolve().parents[1]
F_IN, CLASSES = 12, 3


def _arrays(scale, seed=0, n=40, e=160):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return dict(x=(rng.random((n, F_IN)) * scale).astype(np.float32),
                edge_index=ei, y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_train_part_with_a_correction_matches_jax(scale, tmp_path):
    a = _arrays(scale)
    g, jg = from_data(Data(**a), device="cpu"), j_from_data(JData(**a))
    widths = (4, 20)
    jmodel = jprunable.choose_model("GCN", widths, CLASSES, dropout=0.0)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jmodel.init)({"params": key, "dropout": key}, jg, jg.x)
    model = choose_model("GCN", widths, CLASSES, in_channels=F_IN,
                         dropout=0.0)

    def loss_fn(p):
        from pytorch_geometric_tpu.models.citation import (
            masked_softmax_xent)
        return masked_softmax_xent(jmodel.apply(p, jg, jg.x), jg.y,
                                   jg.train_mask)

    gnorm = float(optax.global_norm(jax.grad(loss_fn)(params)))
    assert (gnorm > 5.0) == (scale > 1.0)
    # the first layer alone (12 + 4 nodes) forms the composed graph: a
    # connected bipartite graph, whose Fiedler signs are stable (two
    # layers make two components, and eigh's basis of a repeated
    # eigenvalue follows the rounding)
    kw = dict(num_classes=CLASSES, method="preferential_attachment",
              vector_pairs=3, correction_coeff=0.01, max_layer_nodes=16)
    want = jdriver.train_part(jmodel, jg, params, 3, lr=0.01,
                              correction_epochs=[2], correction_kwargs=kw)
    ckpt = CheckpointManager(str(tmp_path))
    got = driver.train_part(model, g, params_from_jax(params), 3, lr=0.01,
                            correction_epochs=[2], correction_kwargs=kw,
                            ckpt=ckpt, run_key="toy",
                            apply_kwargs=model.operators(g))
    np.testing.assert_allclose(got.train_convergence,
                               want.train_convergence, rtol=1e-4)
    assert got.test_convergence == pytest.approx(want.test_convergence,
                                                 abs=1e-6)
    assert len(got.test_convergence) == 2             # one per span
    assert got.best_acc == pytest.approx(want.best_acc, abs=1e-6)
    assert [c["epoch"] for c in got.corrections] == [2]
    assert got.corrections[0]["applied"] > 0
    fiedler = got.corrections[0]["fiedler"]         # 16 nodes: host eigh
    assert fiedler["device"] == 0 and fiedler["host"] > 0
    flat = params_from_jax(want.params)
    scale_p = max(float(v.abs().max()) for v in flat.values())
    for name, p in got.params.items():
        np.testing.assert_allclose(p.numpy(), flat[name].numpy(), rtol=0,
                                   atol=1e-4 * scale_p)
    ck = ckpt.load("toy")
    assert ck["train_convergence"][:ck["epoch"]] == \
        got.train_convergence[:ck["epoch"]]


@pytest.mark.parametrize("norm_scale", [0.5, 40.0])
def test_clip_by_global_norm_matches_optax(norm_scale):
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) * norm_scale
             for s in ((4, 3), (3,), (2, 5))]
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    driver.clip_by_global_norm(params, 5.0)
    want, _ = optax.clip_by_global_norm(5.0).update(grads, None)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager steps: one torch thread each, so that workers running
    beside this file do not make every step wait on a crowded pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_cora(monkeypatch, f_in=40):
    """``load_citation_dataset`` replaced by a small graph of
    ``CLASSES`` classes (named Cora in the run keys)."""
    a = _arrays(1.0, n=80, e=320)
    a["x"] = np.random.default_rng(7).random((80, f_in)).astype(np.float32)
    g = from_data(Data(**a), device="cpu")
    ds = type("Small", (), {"num_classes": CLASSES})()
    monkeypatch.setattr(driver, "load_citation_dataset",
                        lambda name, root=None, device="cuda": (ds, g))


def test_training_net_on_the_cpu_and_its_resume_quirk(tmp_path,
                                                      monkeypatch):
    _small_cora(monkeypatch)
    results, ckpt_dir = str(tmp_path / "Results"), str(tmp_path / "ck")
    kw = dict(dataset="Cora", epochs=2, fine_tune_epochs=2,
              results_dir=results, ckpt_dir=ckpt_dir, device="cpu")
    (res,) = driver.training_net(**kw)
    widths = contraction_layer_coefficients(40, 2, 0.5, seed=0)
    assert widths == jdriver.contraction_layer_coefficients(40, 2, 0.5,
                                                            seed=0)
    assert res["widths"] == widths
    run_key = f"Cora-GCN2-{'_'.join(map(str, widths))}-0.6-0"
    ckpt = CheckpointManager(ckpt_dir)
    phase1 = ckpt.load(run_key + "-phase1")
    assert phase1 is not None and ckpt.load(run_key + "-phase2") is not None
    want = [max(w, 1) for w in
            retain_network_size(phase1["params"], 0.6)[:2]]
    assert phase1["epoch"] == 2          # one span: saved at its end
    assert res["new_widths"] == want
    assert res["corrections"] == []      # no correction epoch before 2
    curves = sorted(p.name for p in (tmp_path / "Results" /
                                     "CoraConvergence").iterdir())
    tag = f"Cora-GCN2-param_{'_'.join(map(str, widths))}_0.6-monte_0.npy"
    assert curves == [f"TestConvergence-{tag}", f"TrainConvergence-{tag}"]

    looked_up = []
    resume = CheckpointManager.resume
    monkeypatch.setattr(CheckpointManager, "resume",
                        lambda self, key: looked_up.append(key)
                        or resume(self, key))
    driver.training_net(resume=True, **kw)
    assert looked_up == [run_key]
    assert ckpt.resume(run_key) is None
    assert ckpt.resume(run_key + "-phase1") is not None


def test_training_net_fused_gat_false_raises_on_a_card(monkeypatch,
                                                       tmp_path):
    _small_cora(monkeypatch)
    ds, g = driver.load_citation_dataset("Cora")
    meta = g.replace(x=torch.empty(g.x.shape, device="meta"))
    monkeypatch.setattr(driver, "load_citation_dataset",
                        lambda name, root=None, device="cuda": (ds, meta))
    with pytest.raises(ValueError, match="not summed by plain segment ops"):
        driver.training_net(model_name="GAT", fused_gat=False, device="cpu",
                            results_dir=str(tmp_path / "R"),
                            ckpt_dir=str(tmp_path / "c"))
    assert not list(tmp_path.iterdir())           # refused before writing


def test_training_net_ppi_and_graphcls_run_on_the_cpu(tmp_path):
    (res,) = driver.training_net_ppi(
        epochs=1, fine_tune_epochs=1, batch_size=4,
        results_dir=str(tmp_path / "R"), ckpt_dir=str(tmp_path / "c"),
        device="cpu")
    assert res["widths"] == jdriver.contraction_layer_coefficients(
        50, 2, 0.5, seed=0)
    assert 0.0 <= res["finetune_best"] <= 1.0 and res["operators"] > 0
    (res,) = driver.training_net_graphcls(
        "ENZYMES", num_layers=2, epochs=1, fine_tune_epochs=1,
        batch_size=200, results_dir=str(tmp_path / "R"),
        ckpt_dir=str(tmp_path / "c"), device="cpu")
    assert res["widths"] == jdriver.contraction_layer_coefficients(
        128, 2, 0.5, seed=0)
    assert len(res["new_widths"]) == 2 and min(res["new_widths"]) >= 2
    assert 0.0 <= res["finetune_best"] <= 1.0


def _flags(path):
    """``{option strings: keywords}`` of every ``add_argument`` in
    ``main``."""
    tree = ast.parse(Path(path).read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            opts = tuple(a.value for a in node.args)
            out[opts] = {k.arg: ast.unparse(k.value) for k in node.keywords
                         if k.arg != "help"}
    return out


def test_cli_flags_are_the_jax_drivers():
    port = _flags(REPO / "pytorch_geometric_tpu_torch/research/driver.py")
    ref = _flags(REPO / "pytorch_geometric_tpu/research/driver.py")
    assert port == ref and sum(len(opts) for opts in port) == 20


def test_the_flags_of_later_items_raise(monkeypatch):
    """``--partition`` and ``--gpus`` run now (on two gloo ranks in
    tests/test_torch_port_dist_models.py and
    tests/test_torch_port_data_parallel.py); they raise where the JAX
    driver does, on a model --partition does not take, and where their
    NCCL ranks have no card."""
    with pytest.raises(ValueError, match="GCN/SAGE/GAT"):
        driver.main(["--partition", "2", "--modelName", "RGCN"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--dataset", "ENZYMES", "--gpus", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--partition", "2"])
