"""The port's examples/mygcn.py: a run checkpoints on the best validation
accuracy after each span, and ``resume`` restores the net, Adam's state,
the loss history and the epoch counter from it, then trains on to
``epochs``, as the JAX script (examples/mygcn.py) does; its printed
lines are the JAX script's. On a small graph (in place of Cora), on the
CPU. Its flags are held to the JAX script's in
``tests/test_torch_port_examples.py``."""

import re

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.examples import mygcn
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager

LINE = re.compile(r"Epoch \d{3}  loss \d+\.\d{4}  val \d\.\d{4}  "
                  r"test \d\.\d{4}$")


def _graph(n=60, f=12, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)])
    split = rng.random(n)
    return from_data(Data(
        x=rng.random((n, f)).astype(np.float32), edge_index=ei,
        y=rng.integers(0, classes, n), train_mask=split < 0.5,
        val_mask=(split >= 0.5) & (split < 0.8), test_mask=split >= 0.8),
        device="cpu")


def _small(monkeypatch, seed):
    """``mygcn.load`` replaced by a small graph of three classes."""
    g = _graph(seed=seed)
    ds = type("Small", (), {"num_classes": 3})()
    monkeypatch.setattr(mygcn, "load", lambda name, device: (ds, g))


def test_mygcn_checkpoints_and_resumes_its_epoch_counter(tmp_path, capsys,
                                                         monkeypatch):
    _small(monkeypatch, 0)
    kw = dict(ckpt_dir=str(tmp_path), device="cpu")
    mygcn.run(epochs=40, **kw)
    lines = capsys.readouterr().out.splitlines()
    assert [ln[:9] for ln in lines] == ["Epoch 020", "Epoch 040"]
    assert all(LINE.match(ln) for ln in lines)
    ckpt = CheckpointManager(str(tmp_path))
    saved = ckpt.load("mygcn-Cora")
    assert saved["epoch"] in (20, 40)
    assert len(saved["train_convergence"]) == saved["epoch"]

    # resuming at the saved epoch trains nothing: the saved net evaluates
    # to the saved validation accuracy
    out = mygcn.run(epochs=saved["epoch"], resume=True, **kw)
    assert capsys.readouterr().out.splitlines() == [
        f"=> resumed from epoch {saved['epoch']} "
        f"(best val {saved['metric']:.4f})"]
    assert float(out["val_acc"]) == saved["metric"]

    mygcn.run(epochs=60, resume=True, **kw)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"=> resumed from epoch {saved['epoch']} ")
    spans = list(range(saved["epoch"] + 20, 61, 20))
    assert [ln[:9] for ln in lines[1:]] == [f"Epoch {e:03d}" for e in spans]
    final = ckpt.load("mygcn-Cora")
    assert final["metric"] >= saved["metric"]
    assert final["train_convergence"][:saved["epoch"]] == \
        saved["train_convergence"]
    assert len(final["train_convergence"]) == final["epoch"]


def test_resume_restores_adams_state(tmp_path, monkeypatch):
    _small(monkeypatch, 1)
    kw = dict(ckpt_dir=str(tmp_path), device="cpu")
    mygcn.run(epochs=20, **kw)
    saved = CheckpointManager(str(tmp_path)).load("mygcn-Cora")
    restored = {}
    make = mygcn.create_gcn_train_step

    def spy(model, graph, **k):
        step, ev = make(model, graph, **k)
        restored["opt"], restored["model"] = step.optimizer, model
        return step, ev

    monkeypatch.setattr(mygcn, "create_gcn_train_step", spy)
    mygcn.run(epochs=20, resume=True, **kw)
    opt_state = restored["opt"].state_dict()
    for idx, st in saved["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(opt_state["state"][idx][k].cpu(), v)
    for k, v in restored["model"].state_dict().items():
        assert torch.equal(v, saved["params"][k])
