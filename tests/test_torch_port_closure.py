"""Port parity, training closures: ``layered_training_closure``,
``gcn_closure_norm`` and ``rgcn_closure_norm`` bitwise against the JAX
package on the same numpy edges; the closure paths of ``GCNConv``,
``GATConv`` and ``RGCNConv`` and the closure ``GCN``, ``GAT`` and
``RGCN`` forwards and gradients against the JAX closure forwards, and
against the port's own full-graph forward at the seeds; three Adam steps
of the closure GCN trainer against the JAX
``create_gcn_train_step(closure=True)``.

Each closure path runs both ways on the CPU: through its operator (the
kernels' plain versions: ``gcn_closure_operator``'s rectangular SpMM,
``gat_closure_op``'s ``PackedFlashGat``, ``rgcn_closure_op``'s
``PackedRgcnSpmm``) and, where the port keeps one, through plain
segment ops. Tolerances, relative to the largest reference magnitude:
exact for the closure fields and the norms; fp32 1e-5 forward and 1e-4
for gradients and the trainer's steps. Dropout is off: the port hashes
attention dropout from each edge's CSR position, the JAX closure draws
``jax.random.bernoulli``, so the two cannot agree draw for draw (the JAX
package calls the closure equal to the full graph "up to dropout RNG").
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.data.closure import (
    layered_training_closure as j_closure)
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv.gcn_conv import (
    gcn_closure_norm as j_gcn_closure_norm)
from pytorch_geometric_tpu.nn.conv.rgcn_conv import (
    rgcn_closure_norm as j_rgcn_closure_norm)
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.data.closure import (
    ClosureLayer, layered_training_closure)
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.models import entities as tent
from pytorch_geometric_tpu_torch.nn.conv import GATConv, RGCNConv
from pytorch_geometric_tpu_torch.nn.conv.gat_conv import (
    gat_closure_op, gat_sparse_edge_set)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (
    gcn_closure_norm, gcn_closure_operator, gcn_norm)
from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import (
    rgcn_closure_norm, rgcn_closure_op, rgcn_norm)
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from examples.gat import GAT as JGAT  # noqa: E402
from examples.rgcn import Net as JRGCN  # noqa: E402

R = 4


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _edges(seed, n, e, r=None, unique=False):
    """A multigraph (duplicate edges and self loops kept unless
    ``unique``), with edge types when ``r`` is given."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if unique:
        ei = np.unique(ei, axis=1)
    et = None if r is None else rng.integers(0, r, ei.shape[1])
    return ei, et


def _citation(seed=0, n=80, e=400, f=12, c=3, unique=False):
    rng = np.random.default_rng(seed + 100)
    ei, _ = _edges(seed, n, e, unique=unique)
    tm = np.zeros(n, bool)
    tm[rng.choice(n, 6, replace=False)] = True
    arrays = dict(x=rng.normal(size=(n, f)).astype(np.float32),
                  edge_index=ei, y=rng.integers(0, c, n), train_mask=tm,
                  val_mask=~tm, test_mask=~tm)
    return from_data(Data(**arrays), device="cpu"), \
        j_from_data(JData(**arrays))


def _real_ei(g):
    m = np.asarray(g.real_edge_mask())
    return np.stack([np.asarray(g.senders)[m], np.asarray(g.receivers)[m]])


def _fields_equal(port: ClosureLayer, ref):
    for name in ClosureLayer._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


# ---------------------------------------------------------------------------
# extraction and norms, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("typed,layers,pad", [(False, 2, 128), (True, 2, 32),
                                              (True, 3, 16)])
def test_layered_training_closure_matches_jax_bitwise(typed, layers, pad):
    ei, et = _edges(1, 120, 500, R if typed else None)
    seeds = np.array([7, 3, 90, 41, 3 + 110])
    got = layered_training_closure(ei, seeds, layers, num_nodes=128,
                                   edge_type=et, pad_multiple=pad,
                                   device="cpu")
    want = j_closure(ei, seeds, layers, num_nodes=128, edge_type=et,
                     pad_multiple=pad)
    assert len(got) == len(want) == layers
    for a, b in zip(got, want):
        _fields_equal(a, b)
    # the last layer's outputs are the seeds, in order; outputs are a
    # prefix of the inputs
    assert list(got[-1].out_global[:5].numpy()) == list(seeds)
    for cl in got:
        k = cl.num_real_out
        np.testing.assert_array_equal(cl.in_global[:k], cl.out_global[:k])


def test_closure_norms_match_jax_bitwise():
    g, jg = _citation(2)
    ei = _real_ei(jg)
    seeds = np.flatnonzero(np.asarray(jg.train_mask))
    layers = layered_training_closure(ei, seeds, 2, num_nodes=g.num_nodes,
                                      pad_multiple=32, device="cpu")
    jlayers = j_closure(ei, seeds, 2, num_nodes=jg.num_nodes, pad_multiple=32)
    for improved in (False, True):
        got = gcn_closure_norm(ei, g.num_nodes, layers, improved)
        want = j_gcn_closure_norm(ei, jg.num_nodes, jlayers, improved)
        for (we, ws), (jwe, jws) in zip(got, want):
            np.testing.assert_array_equal(we.numpy(), np.asarray(jwe))
            np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    ei, et = _edges(3, 60, 300, R)
    layers = layered_training_closure(ei, [2, 11, 30, 59], 2, num_nodes=64,
                                      edge_type=et, pad_multiple=32,
                                      device="cpu")
    jlayers = j_closure(ei, [2, 11, 30, 59], 2, num_nodes=64, edge_type=et,
                        pad_multiple=32)
    for cl, jcl in zip(layers, jlayers):
        np.testing.assert_array_equal(rgcn_closure_norm(cl, R).numpy(),
                                      np.asarray(j_rgcn_closure_norm(jcl, R)))


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def _gcn_setup(seed=4):
    g, jg = _citation(seed)
    ei = _real_ei(jg)
    seeds = np.flatnonzero(np.asarray(jg.train_mask))
    jlayers = j_closure(ei, seeds, 2, num_nodes=jg.num_nodes,
                        pad_multiple=32)
    jnorms = j_gcn_closure_norm(ei, jg.num_nodes, jlayers)
    jx0 = jnp.take(jg.x, jlayers[0].in_global, axis=0)
    jmodel = jcit.GCN(hidden_channels=8, num_classes=3)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, None, jx0,
                         closure=jlayers, closure_norms=jnorms)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.ones_like(a), params)   # biases take part
    layers = layered_training_closure(ei, seeds, 2, num_nodes=g.num_nodes,
                                      pad_multiple=32, device="cpu")
    norms = gcn_closure_norm(ei, g.num_nodes, layers)
    model = tcit.GCN(12, 8, 3, dropout_rate=0.5)
    model.load_state_dict(params_from_jax(params))
    return g, jg, seeds, (jmodel, params, jlayers, jnorms, jx0), \
        (model, layers, norms)


@pytest.fixture(scope="module")
def gcn_jax():
    """The JAX closure GCN's output and gradients, computed once."""
    _, _, _, (jmodel, params, jlayers, jnorms, jx0), (_, layers, _) = \
        _gcn_setup()
    proj = np.random.default_rng(5).normal(
        size=(layers[1].n_out, 3)).astype(np.float32)

    @jax.jit
    def grads(p):
        def jloss(p):
            out = jmodel.apply(p, None, jx0, closure=jlayers,
                               closure_norms=jnorms)
            return jnp.sum(out * proj), out
        return jax.value_and_grad(jloss, has_aux=True)(p)
    (_, jout), jgrads = grads(params)
    return proj, jout, jgrads


@pytest.mark.parametrize("path", ["plain", "operator"])
def test_gcn_closure_forward_and_grads_match_jax(path, gcn_jax):
    g, jg, seeds, _, port_side = _gcn_setup()
    model, layers, norms = port_side
    proj, jout, jgrads = gcn_jax
    ops = None if path == "plain" else tuple(
        gcn_closure_operator(cl, w) for cl, (w, _) in zip(layers, norms))
    out = model(None, g.x[layers[0].in_global.long()], closure=layers,
                closure_norms=norms, aggregate_fn=ops)
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out, jout, 1e-5)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-4)
    with torch.no_grad():   # the seeds' rows of the full-graph forward
        full = model(g, g.x, norm=gcn_norm(g))
    _close(out[:len(seeds)], full[torch.from_numpy(seeds)], 1e-5)


def test_gcn_closure_conv_raises_on_a_card_without_its_operator():
    g, _, _, _, (model, layers, norms) = _gcn_setup()
    x = torch.empty((layers[0].n_in, 12), device="meta")
    with pytest.raises(ValueError, match="gcn_closure_operator"):
        model.conv1.to("meta")(None, x, norm=norms[0], closure=layers[0])


def test_three_closure_gcn_steps_match_jax_trainer():
    """``create_gcn_train_step(closure=True)`` against the JAX closure
    trainer, dropout off (rate 0), Adam 0.01 with the first layer's
    weight decay: the loss of each step, the parameters after three, and
    the full-graph evaluation."""
    g, jg = _citation(6, n=96, e=500)
    jmodel = jcit.GCN(hidden_channels=8, num_classes=3, dropout_rate=0.0)
    init_fn, jstep, jeval = jcit.create_gcn_train_step(jmodel, jg,
                                                       closure=True)
    params, opt = init_fn(jax.random.PRNGKey(1))
    model = tcit.GCN(12, 8, 3, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    step, evaluate = tcit.create_gcn_train_step(model, g, closure=True)
    carry = (params, opt, jax.random.PRNGKey(2))
    jstep = jax.jit(jstep)
    for _ in range(3):
        carry, metrics = jstep(carry, None)
        got = step()
        _close(got["loss"], metrics["loss"], 1e-4)
        _close(got["train_acc"], metrics["train_acc"], 1e-6)
    want = params_from_jax(carry[0])
    for name, p in model.state_dict().items():
        _close(p, want[name], 1e-4)
    jacc = jeval(carry[0])
    got = evaluate()
    for k in ("train_acc", "val_acc", "test_acc"):
        assert abs(float(got[k]) - float(jacc[k])) <= 1e-6, k


def test_train_gcn_closure_on_the_cpu():
    g, _ = _citation(7, n=96, e=500)
    model, metrics = tcit.train_gcn(g, 3, hidden=8, epochs=3,
                                    device="cpu", closure=True)
    assert np.isfinite(metrics["curve"]["loss"]).all()
    assert {"train_acc", "val_acc", "test_acc"} <= set(metrics)
    with pytest.raises(ValueError, match="fused"):
        tcit.create_gcn_train_step(model, g, backend="fused", closure=True)


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------

def test_gat_closure_op_edge_set():
    """The real edges minus the receivers' existing self edges, one loop
    per output row, receiver-sorted; rows past ``n_out`` empty."""
    ei, _ = _edges(8, 50, 240)
    ei[:, :4] = [[5, 9, 9, 2], [5, 9, 3, 7]]     # two self loops
    layers = layered_training_closure(ei, [5, 9, 30], 1, num_nodes=50,
                                      pad_multiple=16, device="cpu")
    cl = layers[0]
    op = gat_closure_op(cl)
    assert op.n == cl.n_in
    rows = np.repeat(np.arange(cl.n_in),
                     np.diff(op.fwd.row_ptr.numpy()))
    cols = op.fwd.col.numpy()
    assert (np.diff(rows) >= 0).all() and rows.max() < cl.n_out
    e = cl.num_real_edges
    s, r = cl.senders[:e].numpy(), cl.receivers[:e].numpy()
    want = sorted(zip(r[s != r].tolist(), s[s != r].tolist())) + \
        [(i, i) for i in range(cl.n_out)]
    assert sorted(zip(rows.tolist(), cols.tolist())) == sorted(want)


@pytest.mark.parametrize("heads,concat", [(3, True), (2, False)])
def test_gat_closure_conv_matches_jax_and_full_graph(heads, concat):
    rng = np.random.default_rng(9)
    n = 70
    ei, _ = _edges(9, n, 350, unique=False)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    g = from_data(Data(x=x, edge_index=ei), device="cpu")
    jg = j_from_data(JData(x=x, edge_index=ei))
    seeds = np.array([3, 12, 40])
    jconv = JGATConv(out_channels=6, heads=heads, concat=concat)
    params = jconv.init(jax.random.PRNGKey(0), jg, jg.x)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.ones_like(a), params)
    jlayers = j_closure(_real_ei(jg), seeds, 1, num_nodes=jg.num_nodes,
                        pad_multiple=32)
    jx0 = jnp.take(jg.x, jlayers[0].in_global, axis=0)
    proj = rng.normal(size=(jlayers[0].n_out, 6 * heads if concat else 6)
                      ).astype(np.float32)

    def jloss(p, x0):
        out = jconv.apply(p, None, x0, closure=jlayers[0])
        return jnp.sum(out * proj), out
    (_, jout), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jx0)

    layers = layered_training_closure(_real_ei(jg), seeds, 1,
                                      num_nodes=g.num_nodes,
                                      pad_multiple=32, device="cpu")
    conv = GATConv(10, 6, heads=heads, concat=concat)
    conv.load_state_dict(params_from_jax(params))
    x0 = g.x[layers[0].in_global.long()].clone().requires_grad_()
    out = conv(None, x0, closure=layers[0])
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out, jout, 1e-5)
    _close(x0.grad, jdx, 1e-4)
    want = params_from_jax(jgrads)
    for name, p in conv.named_parameters():
        _close(p.grad, want[name], 1e-4)
    # against the port's full graph on the sparse path's edge set (the
    # closure keeps repeated edges, each its own softmax slot)
    s, r = gat_sparse_edge_set(g)
    op = PackedFlashGat(senders=s, receivers=r, num_nodes=g.num_nodes,
                        device="cpu")
    with torch.no_grad():
        full = conv(g, g.x, flash_op=op)
    _close(out[:3], full[torch.from_numpy(seeds)], 1e-5)


def test_gat_closure_model_matches_jax_and_keeps_dh_finite():
    """examples/gat.py's ``GAT`` with ``closure=`` (two layers) against the
    port's, through the operators built once; the empty rows past each
    layer's ``n_out`` put no NaN into any gradient."""
    g, jg = _citation(10, n=90, e=420, unique=True)
    seeds = np.flatnonzero(np.asarray(jg.train_mask))
    jlayers = j_closure(_real_ei(jg), seeds, 2, num_nodes=jg.num_nodes,
                        pad_multiple=32)
    jx0 = jnp.take(jg.x, jlayers[0].in_global, axis=0)
    jmodel = JGAT(num_classes=3, hidden=4, heads=2, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(2), jg, jx0, closure=jlayers)

    def jloss(p):
        out = jmodel.apply(p, jg, jx0, closure=jlayers)[:len(seeds)]
        return jcit.masked_softmax_xent(
            out, jnp.asarray(np.asarray(jg.y)[seeds]),
            jnp.ones(len(seeds), bool)), out
    (jl, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    model = tcit.GAT(12, 3, hidden=4, heads=2, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    layers = layered_training_closure(_real_ei(jg), seeds, 2,
                                      num_nodes=g.num_nodes,
                                      pad_multiple=32, device="cpu")
    ops = tuple(gat_closure_op(cl) for cl in layers)
    x0 = g.x[layers[0].in_global.long()].clone().requires_grad_()
    out = model(None, x0, train=True, flash_op=ops,
                closure=layers)[:len(seeds)]
    loss = tcit.masked_softmax_xent(out, g.y[torch.from_numpy(seeds)],
                                    torch.ones(len(seeds), dtype=torch.bool))
    loss.backward()
    _close(out, jout, 1e-5)
    _close(loss, jl, 1e-5)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-4)
        assert torch.isfinite(p.grad).all(), name
    assert torch.isfinite(x0.grad).all()
    assert layers[0].n_in > layers[0].n_out     # empty rows exist
    with torch.no_grad():
        full = model(g, g.x, flash_op=tcit.gat_flash_op(g))
    _close(out.detach(), full[torch.from_numpy(seeds)], 1e-5)


def test_train_gat_closure_on_the_cpu():
    g, _ = _citation(11, n=96, e=500, unique=True)
    _, metrics = tcit.train_gat(g, 3, hidden=4, heads=2, epochs=3,
                                device="cpu", closure=True)
    assert np.isfinite(metrics["curve"]["loss"]).all()
    assert {"train_acc", "val_acc", "test_acc"} <= set(metrics)


# ---------------------------------------------------------------------------
# RGCN
# ---------------------------------------------------------------------------

def _rgcn_setup(seed=12, n=60, e=300):
    ei, et = _edges(seed, n, e, R)
    seeds = np.array([2, 11, 30, 59])
    arrays = dict(edge_index=ei, edge_type=et, num_nodes=n,
                  y=np.random.default_rng(seed).integers(0, 2, n),
                  train_idx=seeds, test_idx=np.arange(10))
    g = from_data(Data(**arrays), device="cpu")
    jg = j_from_data(JData(**arrays))
    return g, jg, ei, et, seeds


@pytest.fixture(scope="module")
def rgcn_jax():
    """examples/rgcn.py's ``Net`` on the closure: its parameters, output
    and gradients, computed once."""
    _, jg, ei, et, seeds = _rgcn_setup()
    jlayers = j_closure(ei, seeds, 2, num_nodes=jg.num_nodes, edge_type=et,
                        pad_multiple=32)
    jnorms = [j_rgcn_closure_norm(cl, R) for cl in jlayers]
    jmodel = JRGCN(num_nodes=jg.num_nodes, num_relations=R, num_classes=3)
    params = jmodel.init(jax.random.PRNGKey(0), None, None, None,
                         closure=jlayers, norms=jnorms)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.ones_like(a), params)
    proj = np.random.default_rng(13).normal(
        size=(jlayers[1].n_out, 3)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply(p, None, None, None, closure=jlayers,
                           norms=jnorms)
        return jnp.sum(out * proj), out
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    return params, proj, jout, jgrads


@pytest.mark.parametrize("path", ["plain", "operator"])
def test_rgcn_closure_matches_jax_and_full_graph(path, rgcn_jax):
    g, _, ei, et, seeds = _rgcn_setup()
    params, proj, jout, jgrads = rgcn_jax

    model = tent.RGCN(g.num_nodes, R, 3, hidden=16, num_bases=30)
    model.load_state_dict(params_from_jax(params))
    layers = layered_training_closure(ei, seeds, 2, num_nodes=g.num_nodes,
                                      edge_type=et, pad_multiple=32,
                                      device="cpu")
    if path == "plain":
        out = model(None, closure=layers,
                    norms=[rgcn_closure_norm(cl, R) for cl in layers])
    else:
        out = model(None, closure=layers, fused_ops=tent.rgcn_closure_ops(
            layers, g.num_nodes, R))
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out, jout, 1e-5)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-4)
    with torch.no_grad():
        full = model(g, norm=rgcn_norm(g, g.edge_type, R))
    _close(out[:len(seeds)].detach(), full[torch.from_numpy(seeds)], 1e-5)


def test_rgcn_closure_op_modes():
    """Embed mode gathers the global senders' table rows, transform mode
    the layer's local input rows; both agree with the conv's plain
    closure path, and an unknown mode raises."""
    g, _, ei, et, seeds = _rgcn_setup(14)
    layers = layered_training_closure(ei, seeds, 2, num_nodes=g.num_nodes,
                                      edge_type=et, pad_multiple=32,
                                      device="cpu")
    op = rgcn_closure_op(layers[0], R, "embed", in_channels=g.num_nodes)
    assert (op.num_nodes, op.num_src_rows) == (layers[0].n_out, g.num_nodes)
    op2 = rgcn_closure_op(layers[1], R, "transform")
    assert (op2.num_nodes, op2.num_src_rows) == (layers[1].n_out,
                                                  layers[1].n_in)
    conv = RGCNConv(16, 5, R, num_bases=3,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(layers[1].n_in, 16,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = conv(None, x, closure=layers[1])
        b = conv(None, x, closure=layers[1], fused_op=op2)
    _close(b, a.numpy(), 1e-5)
    with pytest.raises(ValueError, match="mode"):
        rgcn_closure_op(layers[0], R, "both")


@pytest.mark.parametrize("embed", [True, False])
def test_rgcn_closure_conv_raises_on_a_card_without_its_operator(embed):
    g, _, ei, et, seeds = _rgcn_setup(16)
    layers = layered_training_closure(ei, seeds, 2, num_nodes=g.num_nodes,
                                      edge_type=et, pad_multiple=32,
                                      device="cpu")
    f_in = g.num_nodes if embed else 16
    conv = RGCNConv(f_in, 5, R, num_bases=3,
                    generator=torch.Generator().manual_seed(0)).to("meta")
    x = None if embed else torch.empty((layers[1].n_in, 16), device="meta")
    cl = layers[0] if embed else layers[1]
    with pytest.raises(ValueError, match="rgcn_closure_op"):
        conv(None, x, closure=cl, norm=rgcn_closure_norm(cl, R))


def test_train_rgcn_closure_on_the_cpu():
    g, _, _, _, _ = _rgcn_setup(15, n=80, e=400)
    _, metrics = tent.train_rgcn(g, R, 2, epochs=3, device="cpu",
                                 closure=True)
    loss = metrics["curve"]["loss"]
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    assert {"train_acc", "test_acc"} <= set(metrics)
