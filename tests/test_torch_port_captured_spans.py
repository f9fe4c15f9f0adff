"""The full-batch loops over spans of epochs (``models/capture.py:
EpochSpans``): examples/autoencoder.py (GAE and VGAE), infomax.py,
mygcn.py and ``research/driver.py:train_part``, whose JAX versions jit
their epoch (or scan it over a span) and which a card captures once and
replays over every span.

On the CPU, where the epochs run eagerly (``capture=None`` resolves to
eager there):

- each run is bitwise the loop it replaced (written out here as it
  stood: Adam or AdamW, the gradients set to None each epoch, the losses
  stacked on the device), every epoch's loss, the final parameters and
  the metrics; ``train_part`` with a weight correction between two
  spans, which edits the parameters in place, so the next span (a
  replay, on a card) reads the corrected weights;
- ``mygcn --resume`` loads the checkpoint into the model's own
  parameter storage before the first epoch;
- the spans' bookkeeping: a span's rows, the host work's launches as
  the evaluation stage, the launches by stage in ``run_epochs``' form;
- ``capture=True`` on the CPU raises.

The card's checks (captured against eager bitwise, the device launches
against the eager count) are ``chip_smoke.py``'s ``slice_autoencoder``,
``slice_infomax``, ``mygcn`` and ``slice_driver``.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.examples import autoencoder, infomax, mygcn
from pytorch_geometric_tpu_torch.models import capture as cap
from pytorch_geometric_tpu_torch.models.citation import (
    GCN, create_gcn_train_step, gcn_spmm_operator, masked_accuracy,
    masked_softmax_xent)
from pytorch_geometric_tpu_torch.models.prunable import choose_model
from pytorch_geometric_tpu_torch.nn.models import (
    GAE, VGAE, negative_sampling, split_edges)
from pytorch_geometric_tpu_torch.ops import spmm
from pytorch_geometric_tpu_torch.research import driver, spectral
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager steps: one torch thread each, so that workers running
    beside this file do not make every step wait on a crowded pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, n=60, f=12, e=150):
    """A small undirected graph with features, 3 classes and a split."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = ei[:, ei[0] != ei[1]]
    ei = np.unique(np.concatenate([ei, ei[::-1]], 1), axis=1)
    split = rng.random(n)
    return Data(x=rng.random((n, f)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, 3, n), train_mask=split < 0.5,
                val_mask=(split >= 0.5) & (split < 0.8),
                test_mask=split >= 0.8)


def _same_params(a, b):
    for (name, p), (_, q) in zip(a.state_dict().items(),
                                 b.state_dict().items(), strict=True):
        assert torch.equal(p, q), name


def _old_autoencoder(variational, epochs, data, graph, seed=0):
    """examples/autoencoder.py's loop before the spans (its decoder's
    gathers as now)."""
    op, weights = gcn_spmm_operator(graph)
    fn = op.bind(weights)
    enc = autoencoder.Encoder(graph.num_node_features,
                              variational=variational,
                              generator=torch.Generator().manual_seed(seed))
    ae = VGAE(enc) if variational else GAE(enc)
    pos_s, pos_r = data.train_pos_edge_index
    pos = autoencoder.gathers(pos_s, pos_r, graph.num_nodes, CPU)
    neg = autoencoder.gathers(*negative_sampling(
        pos_s, pos_r, data.num_nodes, len(pos_s), seed=seed + 1),
        graph.num_nodes, CPU)
    test = autoencoder.edges(data.test_pos_edge_index, CPU) + \
        autoencoder.edges(data.test_neg_edge_index, CPU)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01)
    noise = torch.Generator().manual_seed(seed)
    losses, tests = [], []
    for epoch in range(1, epochs + 1):
        opt.zero_grad(set_to_none=True)
        loss = autoencoder.loss_of(ae, enc, graph, pos, neg, fn, noise)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            with torch.no_grad():
                z = enc(graph, graph.x, fn)
            tests.append(ae.test(z[0] if variational else z, *test))
    return torch.stack(losses).numpy(), tests, enc


@pytest.mark.parametrize("variational", [False, True])
def test_autoencoder_spans_are_the_old_loop_bitwise(variational, capsys):
    data = split_edges(_data(), seed=0)
    graph = from_data(data, device="cpu")
    out = autoencoder.run(variational, 40, device="cpu",
                          loaded=(data, graph))
    losses, tests, enc = _old_autoencoder(variational, 40, data, graph)
    assert np.array_equal(out["losses"], losses)
    assert (out["auc"], out["ap"]) == tests[-1]
    _same_params(out["model"], enc)
    assert [ln[:9] for ln in capsys.readouterr().out.splitlines()] == [
        "Epoch 020", "Epoch 040"]


def test_infomax_spans_are_the_old_loop_bitwise():
    graph = from_data(_data(1), device="cpu")
    out = infomax.run(20, hidden=16, device="cpu", graph=graph)
    # examples/infomax.py's loop before the spans
    op, weights = gcn_spmm_operator(graph)
    fn = op.bind(weights)
    model = infomax.Model(graph.num_node_features, 16,
                          generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(20):
        opt.zero_grad(set_to_none=True)
        loss, _ = model(graph, graph.x, rng, fn)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        _, z = model(graph, graph.x, rng, fn)
    tr = (graph.train_mask & graph.node_mask).numpy()
    te = (graph.test_mask & graph.node_mask).numpy()
    acc = infomax.LogisticRegression(max_iter=300).fit(
        z.numpy()[tr], graph.y.numpy()[tr]).score(z.numpy()[te],
                                                   graph.y.numpy()[te])
    assert np.array_equal(out["losses"], torch.stack(losses).numpy())
    assert out["acc"] == acc
    _same_params(out["model"], model)


def _small_mygcn(monkeypatch):
    g = from_data(_data(2), device="cpu")
    ds = type("Small", (), {"num_classes": 3})()
    monkeypatch.setattr(mygcn, "load", lambda name, device: (ds, g))
    return g


def test_mygcn_spans_are_the_old_loop_bitwise(tmp_path, monkeypatch):
    g = _small_mygcn(monkeypatch)
    out = mygcn.run(epochs=50, ckpt_dir=str(tmp_path), device="cpu")
    # examples/mygcn.py's loop before the spans
    model = GCN(g.num_node_features, 16, 3,
                generator=torch.Generator().manual_seed(0))
    epoch_step, eval_fn = create_gcn_train_step(model, g)
    gen = torch.Generator().manual_seed(0)
    history, epoch = [], 0
    while epoch < 50:
        length = min(20, 50 - epoch)
        losses = [epoch_step(gen)["loss"] for _ in range(length)]
        history.extend(torch.stack(losses).tolist())
        epoch += length
    assert out["history"] == history
    _same_params(out["model"], model)
    want = eval_fn()
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_mygcn_resume_loads_into_the_models_own_storage(tmp_path,
                                                        monkeypatch):
    _small_mygcn(monkeypatch)
    mygcn.run(epochs=20, ckpt_dir=str(tmp_path), device="cpu")
    saved = CheckpointManager(str(tmp_path)).load("mygcn-Cora")
    seen = {}
    make = mygcn.create_gcn_train_step

    def spy(model, graph, **kw):
        seen["ptrs"] = [p.data_ptr() for p in model.parameters()]
        seen["model"] = model
        return make(model, graph, **kw)

    monkeypatch.setattr(mygcn, "create_gcn_train_step", spy)
    out = mygcn.run(epochs=20, resume=True, ckpt_dir=str(tmp_path),
                    device="cpu")
    model = seen["model"]
    assert [p.data_ptr() for p in model.parameters()] == seen["ptrs"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["params"][k])
    assert out["history"] == saved["train_convergence"]


def _old_train_part(model, graph, epochs, correction_epochs, kw, ak):
    """``train_part``'s loop before the spans: AdamW, the global-norm
    clip, an evaluation a span and a correction where a span ends at
    one."""
    opt = torch.optim.AdamW(model.parameters(), lr=0.01, weight_decay=5e-4)
    gen = torch.Generator().manual_seed(0)
    train_conv, test_conv = [], []
    for length, correct_after in driver._spans(epochs, correction_epochs):
        model.train()
        losses = []
        for _ in range(length):
            opt.zero_grad(set_to_none=False)
            logits = model(graph, graph.x, train=True, generator=gen, **ak)
            loss = masked_softmax_xent(logits, graph.y, graph.train_mask)
            loss.backward()
            driver.clip_by_global_norm(model.parameters(), 5.0)
            opt.step()
            losses.append(loss.detach())
        train_conv.extend(torch.stack(losses).tolist())
        model.eval()
        with torch.no_grad():
            logits = model(graph, graph.x, **ak)
        test_conv.append(float(masked_accuracy(logits, graph.y,
                                               graph.test_mask)))
        if correct_after:
            spectral.weight_correction(model, **kw)
    return train_conv, test_conv


def test_train_part_spans_with_a_correction_are_the_old_loop_bitwise(
        tmp_path):
    graph = from_data(_data(3), device="cpu")
    kw = dict(num_classes=3, method="preferential_attachment",
              vector_pairs=3, correction_coeff=0.01, max_layer_nodes=16)

    def model():
        return choose_model("GCN", (4, 20), 3, in_channels=12,
                            generator=torch.Generator().manual_seed(0))

    got_model = model()
    ptrs = [p.data_ptr() for p in got_model.parameters()]
    ak = got_model.operators(graph)
    got = driver.train_part(got_model, graph, None, 6,
                            correction_epochs=[2, 4], correction_kwargs=kw,
                            ckpt=CheckpointManager(str(tmp_path)),
                            apply_kwargs=ak)
    assert [c["epoch"] for c in got.corrections] == [2, 4]
    assert all(c["applied"] > 0 for c in got.corrections)
    # the corrections edit the parameters the spans' step holds
    assert [p.data_ptr() for p in got_model.parameters()] == ptrs
    want_model = model()
    train_conv, test_conv = _old_train_part(
        want_model, graph, 6, [2, 4], kw, want_model.operators(graph))
    assert got.train_convergence == train_conv
    assert got.test_convergence == test_conv
    assert len(got.val_convergence) == 3
    _same_params(got_model, want_model)
    metrics = got.spans.metrics()
    assert metrics["seconds"] >= 0.0 and "launches" not in metrics
    assert got.spans.epochs == 6


def test_epoch_spans_report_rows_and_the_host_works_launches():
    """A span returns its epochs' rows; the launches of the host work
    between spans are the evaluation stage (counted here by hand: the
    CPU's wrappers count none)."""
    state = {"n": 0}

    def epoch():
        state["n"] += 1
        return torch.tensor(float(state["n"])), torch.tensor(0.5)

    def evaluate():
        spmm.spmm_csr.launches += 2
        return "acc"

    spans = cap.EpochSpans(epoch, 5, CPU, cols=2)
    assert spans.span(3)[:, 0].tolist() == [1.0, 2.0, 3.0]
    assert spans.between(evaluate) == "acc"
    assert spans.span(2).tolist() == [[4.0, 0.5], [5.0, 0.5]]
    assert spans.epochs == 5 and spans.evaluation == {"spmm_csr": 2}
    more = spans.again(2)
    assert more.span(2)[:, 0].tolist() == [6.0, 7.0] and more.epochs == 2
    assert spans.launches == {"warm_up": {}, "captured_epoch": {},
                              "replays": 0, "evaluation": {"spmm_csr": 2}}
    assert set(spans.metrics()) == {"seconds", "between_seconds"}


@pytest.mark.parametrize("name", ["gae", "infomax", "mygcn", "train_part"])
def test_capture_needs_a_card(name, tmp_path):
    data = _data(4)
    graph = from_data(data, device="cpu")
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        if name == "gae":
            split = split_edges(data, seed=0)
            autoencoder.run(False, 20, device="cpu", capture=True,
                            loaded=(split, from_data(split, device="cpu")))
        elif name == "infomax":
            infomax.run(10, hidden=8, device="cpu", graph=graph,
                        capture=True)
        elif name == "mygcn":
            mygcn.run(epochs=20, ckpt_dir=str(tmp_path), device="cpu",
                      capture=True)
        else:
            model = choose_model("GCN", (4, 20), 3, in_channels=12)
            driver.train_part(model, graph, None, 2, capture=True,
                              apply_kwargs=model.operators(graph))
