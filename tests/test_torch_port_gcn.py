"""Port parity, GCN slice: ``gcn_norm``, ``GCNConv`` on each aggregation
path, the ``GCN`` logits and one-step gradients, and Adam steps of
``create_gcn_train_step`` against the JAX package, with the JAX weights
carried over by ``gcn_params_from_jax`` and dropout off (flax and torch
draw different masks). Tolerances: fp32 1e-5 relative to the largest
reference magnitude; five Adam steps 1e-4 against the JAX default
(segment) path and 1e-2 against its ``pallas=True`` path, whose hybrid
SpMM rounds messages to bf16. Then one full ``train_gcn`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.nn.conv.gcn_conv import GCNConv as JGCNConv
from pytorch_geometric_tpu.nn.conv.gcn_conv import gcn_norm as j_gcn_norm
from pytorch_geometric_tpu.nn.conv.gcn_conv import (
    gcn_norm_dense as j_gcn_norm_dense)
from pytorch_geometric_tpu.ops.spmm import SpmmOperator as JSpmmOperator
from pytorch_geometric_tpu_torch.convert import gcn_params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.datasets import synthetic_citation_graph
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.nn.conv import (
    GCNConv, gcn_norm, gcn_norm_dense)
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm_csr
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

F_IN, HIDDEN, CLASSES = 20, 8, 4


def _arrays(seed=0, n=150, e=700):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = ei[:, ei[0] != ei[1]]
    masks = {"train_mask": rng.random(n) < 0.3,
             "val_mask": rng.random(n) < 0.3,
             "test_mask": rng.random(n) < 0.3}
    return dict(x=rng.random((n, F_IN)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, CLASSES, n), **masks)


def _graphs(seed=0):
    arrays = _arrays(seed)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _jax_gcn(jg, dropout_rate=0.0):
    model = jcit.GCN(hidden_channels=HIDDEN, num_classes=CLASSES,
                     dropout_rate=dropout_rate)
    params = model.init(jax.random.PRNGKey(0), jg, jg.x, j_gcn_norm(jg))
    return model, params


def _port_gcn(params, dropout_rate=0.0):
    model = tcit.GCN(F_IN, HIDDEN, CLASSES, dropout_rate=dropout_rate)
    model.load_state_dict(gcn_params_from_jax(params))
    return model


@pytest.mark.parametrize("improved", [False, True])
def test_gcn_norm_matches_jax(improved):
    g, jg = _graphs()
    got, want = gcn_norm(g, improved=improved), j_gcn_norm(
        jg, improved=improved)
    np.testing.assert_array_equal(got.senders.numpy(),
                                  np.asarray(want.senders))
    np.testing.assert_array_equal(got.receivers.numpy(),
                                  np.asarray(want.receivers))
    _close(got.weights, want.weights, 1e-5)
    # padding edges weigh 0; each padding node's self loop weighs 1
    # (its degree is the loop alone)
    w = got.weights.numpy()
    assert (w[:g.num_edges][~g.edge_mask.numpy()] == 0).all()
    pad = ~g.node_mask.numpy()
    np.testing.assert_allclose(w[g.num_edges:][pad], 1.0)


def test_gcn_norm_dense_matches_jax():
    g, jg = _graphs(1)
    _close(gcn_norm_dense(g), j_gcn_norm_dense(jg), 1e-5)


@pytest.mark.parametrize("path", ["sparse", "dense", "spmm_op",
                                  "aggregate_fn"])
def test_gcn_conv_paths_match_jax(path):
    g, jg = _graphs(2)
    jconv = JGCNConv(HIDDEN)
    params = jconv.init(jax.random.PRNGKey(1), jg, jg.x)
    conv = GCNConv(F_IN, HIDDEN)
    conv.load_state_dict(gcn_params_from_jax(params))
    assert conv.weight.shape == (F_IN, HIDDEN)     # (in, out) as in JAX
    jn, n = j_gcn_norm(jg), gcn_norm(g)
    if path == "sparse":
        jkw, kw = {}, {}
    elif path == "dense":
        jkw = {"norm_dense": j_gcn_norm_dense(jg)}
        kw = {"norm_dense": gcn_norm_dense(g)}
    else:
        jop = JSpmmOperator(np.asarray(jn.senders), np.asarray(jn.receivers),
                            jg.num_nodes, window=64, tile=128)
        op = SpmmOperator(n.senders, n.receivers, g.num_nodes, device="cpu")
        if path == "spmm_op":
            jkw, kw = {"spmm_op": jop}, {"spmm_op": op}
        else:
            jkw = {"aggregate_fn": jop.bind(jn.weights)}
            kw = {"aggregate_fn": op.bind(n.weights)}
    want = jconv.apply(params, jg, jg.x, **jkw)
    got = conv(g, g.x, **kw)
    _close(got, want, 1e-5)


def test_gcn_spmm_operator_leaves_out_padding_edges():
    """The trainer's operator holds the real edges and every self loop,
    and aggregates as the JAX operator over the whole ``gcn_norm`` set."""
    g, jg = _graphs(9)
    op, w = tcit.gcn_spmm_operator(g)
    n_real = int(g.edge_mask.sum())
    assert n_real < g.num_edges
    assert op.fwd.num_edges == op.bwd.num_edges == n_real + g.num_nodes
    pad_node = int(g.node_mask.sum())     # every padding edge points here
    assert (g.receivers[~g.edge_mask] == pad_node).all()
    rp = op.fwd.row_ptr.numpy()
    assert rp[pad_node + 1] - rp[pad_node] == 1      # its self loop alone
    jn = j_gcn_norm(jg)
    jop = JSpmmOperator(np.asarray(jn.senders), np.asarray(jn.receivers),
                        jg.num_nodes, window=64, tile=128)
    x = np.random.default_rng(9).normal(
        size=(g.num_nodes, HIDDEN)).astype(np.float32)
    _close(op.bind(w)(torch.from_numpy(x)), jop.bind(jn.weights)(x), 1e-5)


def _j_loss(model, jg):
    def loss(params):
        logits = model.apply(params, jg, jg.x, j_gcn_norm(jg), train=True)
        wd = sum(jnp.sum(p ** 2) for p in
                 jax.tree_util.tree_leaves(params["params"]["conv1"]))
        return jcit.masked_softmax_xent(logits, jg.y, jg.train_mask) \
            + 5e-4 * wd, logits
    return loss


def test_gcn_logits_and_one_step_grads_match_jax():
    g, jg = _graphs(3)
    jmodel, params = _jax_gcn(jg)
    (jl, jlogits), jgrads = jax.value_and_grad(
        _j_loss(jmodel, jg), has_aux=True)(params)
    model = _port_gcn(params)
    logits = model(g, g.x, train=True)
    loss = tcit.masked_softmax_xent(logits, g.y, g.train_mask) + 5e-4 * sum(
        (p ** 2).sum() for p in model.conv1.parameters())
    loss.backward()
    _close(logits, jlogits, 1e-5)
    _close(loss, jl, 1e-5)
    want = gcn_params_from_jax(jgrads)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-5)


def test_masked_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(60, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 60)
    mask = rng.random(60) < 0.5
    _close(tcit.masked_softmax_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask)),
           jcit.masked_softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask)), 1e-6)
    _close(tcit.masked_accuracy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask)),
           jcit.masked_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask)), 1e-6)


@pytest.mark.parametrize("jax_path,tol", [("default", 1e-4),
                                          ("pallas", 1e-2)])
def test_five_adam_steps_match_jax(jax_path, tol):
    g, jg = _graphs(5)
    jmodel, _ = _jax_gcn(jg)
    kw = {"pallas": True, "window": 64, "tile": 128} \
        if jax_path == "pallas" else {}
    init_fn, jstep, jeval = jcit.create_gcn_train_step(jmodel, jg, **kw)
    params, opt_state = init_fn(jax.random.PRNGKey(0))
    model = _port_gcn(params)
    step, evaluate = tcit.create_gcn_train_step(model, g)
    carry = (params, opt_state, jax.random.PRNGKey(1))
    for _ in range(5):
        carry, jm = jstep(carry, None)
        m = step()
        _close(m["loss"], jm["loss"], tol)
    want = gcn_params_from_jax(carry[0])
    for name, p in model.state_dict().items():
        _close(p, want[name], tol)
    got_eval, want_eval = evaluate(), jeval(carry[0])
    for k in ("train_acc", "val_acc", "test_acc"):
        assert abs(float(got_eval[k]) - float(want_eval[k])) <= 0.02, k


def test_dropout_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = tcit.dropout(x, 0.5, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    assert tcit.dropout(x, 0.5, False, gen) is x
    # the training step draws its masks from the generator it is given
    g, _ = _graphs(6)
    model = tcit.GCN(F_IN, HIDDEN, CLASSES,
                     generator=torch.Generator().manual_seed(0))
    a = model(g, g.x, train=True, generator=torch.Generator().manual_seed(1))
    b = model(g, g.x, train=True, generator=torch.Generator().manual_seed(1))
    c = model(g, g.x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_gcn_output_respects_padding():
    g, _ = _graphs(7)
    model = tcit.GCN(F_IN, HIDDEN, CLASSES,
                     generator=torch.Generator().manual_seed(0))
    nm = g.node_mask
    x2 = torch.where(nm[:, None], g.x, 123.0)
    a = model(g, g.x)[nm]
    b = model(g.replace(x=x2), x2)[nm]
    _close(a, b.detach().numpy(), 1e-5)


def test_gcn_params_from_jax_layout():
    _, jg = _graphs(8)
    _, params = _jax_gcn(jg)
    sd = gcn_params_from_jax(params)
    assert sorted(sd) == ["conv1.bias", "conv1.weight", "conv2.bias",
                          "conv2.weight"]
    assert sd["conv1.weight"].shape == (F_IN, HIDDEN)
    assert sd["conv2.weight"].shape == (HIDDEN, CLASSES)
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_train_gcn_cpu_synthetic_cora():
    data = NormalizeFeatures()(synthetic_citation_graph("cora"))
    graph = from_data(data, device="cpu")
    assert (graph.num_nodes, graph.num_edges) == (3072, 12288)
    before = spmm_csr.launches
    _, metrics = tcit.train_gcn(graph, num_classes=7, device="cpu")
    assert metrics["val_acc"] > 0.6 and metrics["test_acc"] > 0.6
    loss = metrics["curve"]["loss"]
    assert loss.shape == (200,) and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
    assert spmm_csr.launches == before            # CPU: the plain path
