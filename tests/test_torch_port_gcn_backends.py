"""Port parity, GCN backends: ``SortedSpmm`` / ``SortedSegmentSum``,
``keep_mask``, ``FusedGcn2``, ``SpmmOperator.bind_external`` and the
``backend=`` switch of ``create_gcn_train_step`` against the JAX package,
on the CPU (the wrappers compute their plain versions there).

Tolerances, relative to the largest reference magnitude: fp32 1e-5
(gradients 1e-4) against the JAX fp32 paths and the port's own fp32
composition; 2e-2 against the JAX operators that round to bf16 (bf16
messages, the dense bf16 adjacency); the JAX ``FusedGcn2`` with its own
test's gates (forward 2e-2 of 1 + max; gradients mean 3e-3 and max 8e-2 of
1 + max, since it rounds its gathers to bf16 and a relu may flip).
Parity seeds are integers that float32 holds exactly, because the JAX
fused op takes its seed as a float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.nn.conv.gcn_conv import gcn_norm as j_gcn_norm
from pytorch_geometric_tpu.nn.conv.gcn_conv import (
    gcn_norm_dense as j_gcn_norm_dense)
from pytorch_geometric_tpu.ops.fused_gcn import FusedGcn2 as JFusedGcn2
from pytorch_geometric_tpu.ops.fused_gcn import _host_keep_mask
from pytorch_geometric_tpu.ops.sorted_spmm import (
    SortedSegmentSum as JSortedSegmentSum)
from pytorch_geometric_tpu.ops.sorted_spmm import SortedSpmm as JSortedSpmm
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.ops import fused_gcn as fg
from pytorch_geometric_tpu_torch.ops import sorted_spmm as ss
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm

N, E, H, C = 256, 1200, 16, 3
F_IN, CLASSES = 20, 4
SEED = 12345


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _edges(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.normal(size=e).astype(np.float32))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# SortedSpmm and SortedSegmentSum
# ---------------------------------------------------------------------------

def test_sorted_spmm_fp32_matches_jax_with_grads():
    s, r, w = _edges(1)
    x = np.random.default_rng(1).normal(size=(N, 16)).astype(np.float32)
    jop = JSortedSpmm(s, r, N, tile=128, rows=128)

    def jloss(w_, x_):
        return jnp.sum(jop(w_, x_) ** 2)

    want = jop(jnp.asarray(w), jnp.asarray(x))
    jdw, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    op = ss.SortedSpmm(s, r, N, device="cpu")
    wt, xt = _t(w, True), _t(x, True)
    out = op(wt, xt)
    (out ** 2).sum().backward()
    _close(out, want, 1e-5)
    _close(wt.grad, jdw, 1e-4)
    _close(xt.grad, jdx, 1e-4)


def test_sorted_spmm_bf16_matches_jax():
    s, r, w = _edges(2)
    x = np.random.default_rng(2).normal(size=(N, 16)).astype(np.float32)
    jop = JSortedSpmm(s, r, N, tile=128, rows=128,
                      compute_dtype=jnp.bfloat16)
    want = np.asarray(jop(jnp.asarray(w), jnp.asarray(x)))
    jdx = np.asarray(jax.grad(lambda x_: jnp.sum(
        jop(jnp.asarray(w), x_) ** 2))(jnp.asarray(x)))
    op = ss.SortedSpmm(s, r, N, compute_dtype=torch.bfloat16, device="cpu")
    xt = _t(x, True)
    out = op(_t(w), xt)
    (out ** 2).sum().backward()
    for got, ref in ((out.detach().numpy(), want),
                     (xt.grad.numpy(), jdx)):
        sc = 1 + np.abs(ref).max()
        np.testing.assert_allclose(got / sc, ref / sc, atol=2e-2)


@pytest.mark.parametrize("case,f", [
    pytest.param(case, f, id=case if f == 20 else f"{case}-{f}")
    for f in (20, 257, 1024) for case in ("empty_rows", "one_row")])
def test_sorted_segment_sum_matches_jax(case, f):
    """Rows that receive nothing give 0; a row that receives every edge
    sums them all; the VJP gathers the cotangent at the receivers. At 20
    channels (the card's first design), 257 (odd: the chunk map at one
    channel a load) and 1024 (the chunk map at a float4 a lane, DNA's
    widest)."""
    rng = np.random.default_rng(3)
    r = (rng.integers(0, N - 20, E) if case == "empty_rows"
         else np.full(E, 7))
    msgs = rng.normal(size=(E, f)).astype(np.float32)
    jop = JSortedSegmentSum(r, N, tile=128, rows=128)
    want = jop(jnp.asarray(msgs))
    jg = jax.grad(lambda m: jnp.sum(jop(m) ** 3))(jnp.asarray(msgs))
    op = ss.SortedSegmentSum(r, N, device="cpu")
    mt = _t(msgs, True)
    out = op(mt)
    (out ** 3).sum().backward()
    _close(out, want, 1e-5)
    _close(mt.grad, jg, 1e-4)
    assert (out[N - 20:] == 0).all() if case == "empty_rows" else \
        (out[torch.arange(N) != 7] == 0).all()


def test_sorted_segment_sum_plain_is_the_cpu_wrapper():
    s, r, _ = _edges(4)
    op = ss.SortedSpmm(s, r, N, device="cpu")
    msgs = torch.randn(E, 5, generator=torch.Generator().manual_seed(4))
    before = ss.sorted_segment_sum.launches
    got = ss.sorted_segment_sum(op.fwd.row_ptr, msgs.to(torch.bfloat16))
    want = ss.sorted_segment_sum_plain(op.fwd.row_ptr,
                                       msgs.to(torch.bfloat16))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert ss.sorted_segment_sum.launches == before
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(op.fwd.row_ptr, msgs.double())
    with pytest.raises(TypeError):
        ss.sorted_segment_sum(op.fwd.row_ptr.long(), msgs)


# ---------------------------------------------------------------------------
# keep_mask and FusedGcn2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 12345, 987654, 2 ** 24, 10 ** 9])
def test_keep_mask_equals_jax_bit_for_bit(rate, seed):
    want = np.asarray(_host_keep_mask(jnp.float32(seed), H, 300, 128, rate))
    got = fg.keep_mask(seed, H, 300, rate)
    assert got.shape == (300, H) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    as_tensor = fg.keep_mask(torch.tensor([seed], dtype=torch.int32), H, 300,
                             rate)
    assert torch.equal(as_tensor, got)
    assert abs(got.float().mean().item() - (1 - rate)) < 0.02


def _fused_inputs(seed=5):
    rng = np.random.default_rng(seed)
    s, r, w = _edges(seed)
    return (s, r, w, rng.normal(size=(N, H)).astype(np.float32),
            rng.normal(size=(H, C)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32))


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["rate0", "rate0.5"])
def jax_fused(request):
    """The JAX ``FusedGcn2`` (Pallas in interpret mode) on one set of
    inputs: its output and the gradients of sum(out^2), built once."""
    rate = request.param
    s, r, w, z1, W2, b1 = _fused_inputs()
    op = JFusedGcn2(s, r, N, w, hidden=H, classes=C, window=128, tile=128,
                    dropout_rate=rate)
    seed = jnp.float32(SEED)
    args = tuple(jnp.asarray(a) for a in (z1, W2, b1))
    out = np.asarray(op(*args, seed))
    grads = jax.grad(lambda a, b, c: jnp.sum(op(a, b, c, seed) ** 2),
                     argnums=(0, 1, 2))(*args)
    return rate, out, [np.asarray(g) for g in grads]


def _port_fused(rate):
    s, r, w, z1, W2, b1 = _fused_inputs()
    op = fg.FusedGcn2(s, r, N, w, hidden=H, classes=C, dropout_rate=rate,
                      device="cpu")
    params = [_t(a, True) for a in (z1, W2, b1)]
    out = op(*params, SEED)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [p.grad.numpy() for p in params]


def test_fused_gcn2_matches_jax(jax_fused):
    rate, want, jgrads = jax_fused
    out, grads = _port_fused(rate)
    sc = 1 + np.abs(want).max()
    assert np.abs(out - want).max() / sc < 2e-2
    for name, a, b in zip(("dz1", "dW2", "db1"), grads, jgrads):
        sc = 1 + np.abs(b).max()
        assert np.abs(a - b).mean() / sc < 3e-3, name
        assert np.abs(a - b).max() / sc < 8e-2, name


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fused_gcn2_matches_fp32_composition(rate):
    """Against the same function composed of plain fp32 ops (per-edge
    SpMM, relu, ``keep_mask``), differentiated by autograd."""
    s, r, w, z1, W2, b1 = _fused_inputs()
    senders, receivers = torch.from_numpy(s), torch.from_numpy(r)

    def agg(v):
        return spmm(senders, receivers, v, N, weights=torch.from_numpy(w))

    params = [_t(a, True) for a in (z1, W2, b1)]
    h = torch.relu(agg(params[0]) + params[2])
    if rate > 0:
        h = torch.where(fg.keep_mask(SEED, H, N, rate), h / (1 - rate), 0.0)
    want = agg(h @ params[1])
    (want ** 2).sum().backward()
    out, grads = _port_fused(rate)
    _close(out, want.detach(), 1e-5)
    for a, b in zip(grads, params):
        _close(a, b.grad, 1e-4)


def test_fused_gcn_limits_are_refused():
    s, r, w, z1, W2, b1 = _fused_inputs()
    for hidden, classes in ((17, 3), (16, 17), (0, 3)):
        with pytest.raises(ValueError, match="hidden and classes"):
            fg.FusedGcn2(s, r, N, w, hidden=hidden, classes=classes,
                         device="cpu")
    with pytest.raises(ValueError, match="dropout_rate"):
        fg.FusedGcn2(s, r, N, w, hidden=H, classes=C, dropout_rate=1.0,
                     device="cpu")
    op = fg.FusedGcn2(s, r, N, w, hidden=H, classes=C, device="cpu")
    seed = torch.tensor([1], dtype=torch.int32)
    wide = torch.zeros(17, C)
    with pytest.raises(ValueError, match="W2 must be"):
        fg.fused_gcn_fwd(op.op.fwd, op.val_f, torch.zeros(N, 17), wide,
                         torch.zeros(17), seed, 0.5)
    with pytest.raises(ValueError, match="input must be"):
        fg.fused_gcn_fwd(op.op.fwd, op.val_f, torch.zeros(N, 8),
                         _t(W2), _t(b1), seed, 0.5)
    with pytest.raises(TypeError, match="seed"):
        fg.fused_gcn_fwd(op.op.fwd, op.val_f, _t(z1), _t(W2), _t(b1),
                         seed.long(), 0.5)


def test_bind_external_equals_bind():
    s, r, w = _edges(6)
    op = SpmmOperator(s, r, N, device="cpu")
    fn, consts = op.bind_external(w)
    assert set(consts) == {"fwd", "bwd"}
    x = np.random.default_rng(6).normal(size=(N, 7)).astype(np.float32)
    xa, xb = _t(x, True), _t(x, True)
    a, b = fn(consts, xa), op.bind(torch.from_numpy(w))(xb)
    assert torch.equal(a, b)
    (a ** 2).sum().backward()
    (b ** 2).sum().backward()
    assert torch.equal(xa.grad, xb.grad)


# ---------------------------------------------------------------------------
# The trainer's backends
# ---------------------------------------------------------------------------

def _arrays(seed=0, n=150, e=700):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = ei[:, ei[0] != ei[1]]
    masks = {k: rng.random(n) < 0.3
             for k in ("train_mask", "val_mask", "test_mask")}
    return dict(x=rng.random((n, F_IN)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, CLASSES, n), **masks)


def _graphs(seed=0):
    arrays = _arrays(seed)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _model(seed=0):
    return tcit.GCN(F_IN, H, CLASSES,
                    generator=torch.Generator().manual_seed(seed))


def _train(graph, backend, steps=3, seed=0):
    model = _model(seed)
    step, evaluate = tcit.create_gcn_train_step(model, graph,
                                                backend=backend)
    gen = torch.Generator().manual_seed(seed)
    losses = [step(gen)["loss"] for _ in range(steps)]
    return model, losses, evaluate()


def test_sorted_backend_trains_as_packed():
    g, _ = _graphs(1)
    packed, lp, ep = _train(g, "packed")
    sorted_, ls, es = _train(g, "sorted")
    for a, b in zip(ls, lp):
        _close(a, b, 1e-5)
    want = packed.state_dict()
    for name, p in sorted_.state_dict().items():
        _close(p, want[name], 1e-5)
    assert es == ep


def test_fused_backend_is_a_plain_step_with_the_hash_mask():
    """Three Adam steps of the fused backend against the same steps
    written in plain fp32 ops: input dropout from the generator, then the
    seed drawn from it, the hidden layer dropped by ``keep_mask``."""
    g, _ = _graphs(2)
    fused, lf, _ = _train(g, "fused")
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    s, r, w = tcit.gcn_edge_set(g)
    gen = torch.Generator().manual_seed(0)
    c1, c2 = model.conv1, model.conv2
    for lf_k in lf:
        opt.zero_grad()
        x = tcit.dropout(g.x, 0.5, True, gen)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             dtype=torch.int32)
        h = torch.relu(spmm(s, r, x @ c1.weight, g.num_nodes, weights=w)
                       + c1.bias)
        h = torch.where(fg.keep_mask(seed, H, g.num_nodes, 0.5), h / 0.5,
                        0.0)
        logits = spmm(s, r, h @ c2.weight, g.num_nodes, weights=w) + c2.bias
        loss = tcit.masked_softmax_xent(logits, g.y, g.train_mask) \
            + 5e-4 * sum((p ** 2).sum() for p in c1.parameters())
        loss.backward()
        opt.step()
        _close(lf_k, loss.detach(), 1e-5)
    want = model.state_dict()
    for name, p in fused.state_dict().items():
        _close(p, want[name], 1e-5)


@pytest.mark.parametrize("backend", ["packed", "sorted", "fused", "dense"])
def test_each_backend_matches_the_jax_gcn_forward(backend):
    """The JAX ``GCN`` forward (dropout off) with its weights carried over
    by ``params_from_jax``, against each backend's evaluation forward
    (fp32 1e-5 against the JAX sparse path; the dense backend 2e-2 against
    the JAX ``dense=True`` bf16 adjacency). The fused backend's training
    forward at dropout 0 is held to it too."""
    g, jg = _graphs(3)
    jmodel = jcit.GCN(hidden_channels=H, num_classes=CLASSES)
    params = jmodel.init(jax.random.PRNGKey(3), jg, jg.x, j_gcn_norm(jg))
    model = tcit.GCN(F_IN, H, CLASSES)
    model.load_state_dict(params_from_jax(params))
    agg, fused = tcit.gcn_backend(g, backend, H, CLASSES, dropout_rate=0.0)
    with torch.no_grad():
        got = model(g, g.x, **agg)
    if backend == "dense":
        want = jmodel.apply(params, jg, jg.x, norm_dense=j_gcn_norm_dense(
            jg, dtype=jnp.bfloat16))
        _close(got, want, 2e-2)
        return
    want = jmodel.apply(params, jg, jg.x, j_gcn_norm(jg))
    _close(got, want, 1e-5)
    if fused is not None:
        c1, c2 = model.conv1, model.conv2
        with torch.no_grad():
            train_fwd = fused(g.x @ c1.weight, c2.weight, c1.bias, 0) \
                + c2.bias
        _close(train_fwd, want, 1e-5)


def test_backends_refuse_unknown_names_and_dense_past_its_cap():
    g, _ = _graphs(4)
    for name in ("pallas", "bsr", "auto", ""):
        with pytest.raises(ValueError, match="backend must be"):
            tcit.gcn_backend(g, name)
        with pytest.raises(ValueError, match="backend must be"):
            tcit.train_gcn(g, CLASSES, epochs=1, device="cpu", backend=name)
    big = from_data(Data(x=np.zeros((8200, 2), np.float32),
                         edge_index=np.zeros((2, 1), np.int64),
                         y=np.zeros(8200, np.int64)), device="cpu")
    assert big.num_nodes > tcit.GCN_DENSE_MAX_NODES
    with pytest.raises(ValueError, match="at most 8192"):
        tcit.gcn_backend(big, "dense")


@pytest.mark.parametrize("backend", ["sorted", "fused", "dense"])
def test_train_gcn_cpu_backends_learn(backend):
    g, _ = _graphs(5)
    _, metrics = tcit.train_gcn(g, CLASSES, epochs=10, device="cpu",
                                backend=backend)
    loss = metrics["curve"]["loss"]
    assert loss.shape == (10,) and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
