"""Port parity, GAT slice: the dropout hash, the fused path's edge set,
``PackedFlashGat`` (its kernels' plain versions on the CPU), ``GATConv``
on each path, the ``GAT`` of examples/gat.py and its AdamW steps, against
the JAX package run as its own tests run it on the CPU (Pallas interpret
mode, ``window = tile = 128``).

Tolerances, relative to the largest reference magnitude:

- fp32 1e-5 against the JAX fp32 paths (the sparse segment-softmax GAT,
  and the example's GAT on it); gradients of the fused op 1e-4, five
  AdamW steps 1e-4;
- 2e-2 against the JAX ``PackedFlashGat``, which rounds ``s|h``, ``d`` and
  the incoming gradient to bf16 for its one-hot matrix products; its
  gradients by relative L2 norm within 5e-2, as its own tests gate them.

The graphs hold no duplicate edges: the fused path collapses them to one
softmax slot, the sparse path gives each its own. Dropout is off where
flax and torch would draw different masks; the attention dropout of the
fused path is a hash of (seed, edge id, head), so both packages drop the
same (edge, head) pairs from one seed, and that is compared with it on.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv import gat_dense_adj
from pytorch_geometric_tpu.ops import segment as jseg
from pytorch_geometric_tpu.ops.packed_gat import PackedFlashGat as JPacked
from pytorch_geometric_tpu.ops.packed_gat import _edge_keep_bits
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.nn.conv import GATConv, gat_edge_set
from pytorch_geometric_tpu_torch.ops import packed_gat as pg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from examples.gat import GAT as JGAT  # noqa: E402

F_IN, CLASSES = 12, 4


def _arrays(seed=0, n=240, e=900):
    """A graph without duplicate edges, with pre-existing self loops (at
    nodes 0-5) and, once padded, padding nodes and edges."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    loops = np.tile(np.arange(6), (2, 1))
    ei = np.unique(np.concatenate([ei, loops], axis=1), axis=1)
    return dict(x=rng.normal(size=(n, F_IN)).astype(np.float32),
                edge_index=ei,
                y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.4, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


def _graphs(seed=0):
    arrays = _arrays(seed)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _node_inputs(seed, n, H, C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((n, H), (n, H), (n, H * C), (n, H * C),
                          (n, H * C + H))]


def _port_op(g):
    s, r = gat_edge_set(g)
    return pg.PackedFlashGat(senders=s, receivers=r, num_nodes=g.num_nodes,
                             device="cpu")


def _port_vjp(op, d, s, h, proj, seed, rate, raw_out):
    ts = [torch.from_numpy(a).requires_grad_() for a in (d, s, h)]
    out = op(*ts, seed, rate=rate, raw_out=raw_out)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _jax_vjp(fn, d, s, h, proj):
    def loss(d, s, h):
        return jnp.sum(fn(d, s, h) * proj)
    return fn(d, s, h), jax.grad(loss, argnums=(0, 1, 2))(d, s, h)


# ---------------------------------------------------------------------------
# host side: hash, edge set, CSR alignment
# ---------------------------------------------------------------------------

def test_edge_keep_bits_match_jax_bitwise():
    eid = np.concatenate([np.arange(4096), [2 ** 31 - 1, 2 ** 30 + 7,
                                            123456789]]).astype(np.int64)
    heads = np.arange(8)
    for seed in (0, 5, 2 ** 20 - 1):
        want = np.asarray(_edge_keep_bits(
            jnp.asarray(seed, jnp.int32),
            jnp.asarray(eid[:, None].astype(np.int32)),
            jnp.asarray(heads[None].astype(np.int32)))).astype(np.int64)
        got = pg.edge_keep_bits(torch.tensor(seed),
                                torch.from_numpy(eid)[:, None],
                                torch.from_numpy(heads)[None])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate,thresh,scale", [
    (0.0, 0, 1.0), (0.6, 2576980377, 2.5), (1.0, 2 ** 32 - 1, None)])
def test_dropout_threshold_and_scale_follow_the_jax_rule(rate, thresh,
                                                         scale):
    # keep iff bits >= min(int(rate * 2**32), 2**32 - 1), scale 1/(1-rate)
    assert pg.dropout_threshold(rate) == thresh
    if scale is not None:
        assert pg.dropout_scale(rate) == pytest.approx(scale)


def test_edge_set_matches_nonzero_of_dense_adj():
    g, jg = _graphs(1)
    assert int((g.senders == g.receivers).sum()) > 6   # loops, padding
    senders, receivers = gat_edge_set(g)
    want_r, want_s = np.nonzero(np.asarray(gat_dense_adj(jg)))
    np.testing.assert_array_equal(receivers, want_r)
    np.testing.assert_array_equal(senders, want_s)
    # one self loop per node, padding nodes included
    loops = senders == receivers
    np.testing.assert_array_equal(np.sort(senders[loops]),
                                  np.arange(g.num_nodes))


def test_sender_major_edge_ids_point_at_the_same_edges():
    """The sender-major CSR's ``bwd_eid`` is the receiver-major position
    of the same (sender, receiver) pair: the id that dropout hashes."""
    g, _ = _graphs(2)
    op = _port_op(g)
    fwd_rows = np.repeat(np.arange(op.n), np.diff(op.fwd.row_ptr.numpy()))
    bwd_rows = np.repeat(np.arange(op.n), np.diff(op.bwd.row_ptr.numpy()))
    eid = op.bwd_eid.numpy()
    assert op.bwd_eid.dtype == torch.int32
    np.testing.assert_array_equal(fwd_rows[eid], op.bwd.col.numpy())
    np.testing.assert_array_equal(op.fwd.col.numpy()[eid], bwd_rows)
    np.testing.assert_array_equal(np.sort(eid), np.arange(op.E))


def test_packed_flash_gat_refuses_unordered_edges():
    """Receivers that decrease are refused (the CSR position would not
    be the input index that dropout hashes); repeated pairs are not."""
    with pytest.raises(ValueError, match="must not decrease"):
        pg.PackedFlashGat(senders=np.array([0, 1]),
                          receivers=np.array([1, 0]), num_nodes=2,
                          device="cpu")
    op = pg.PackedFlashGat(senders=np.array([1, 1, 0]),
                           receivers=np.array([0, 0, 1]), num_nodes=2,
                           device="cpu")
    assert op.E == 3
    with pytest.raises(ValueError, match="adj_bool, or senders"):
        pg.PackedFlashGat(senders=np.array([0]), num_nodes=2, device="cpu")


# ---------------------------------------------------------------------------
# the fused op against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("raw_out", [False, True])
def test_packed_flash_gat_matches_jax_packed(rate, raw_out):
    """Forward and grads of d, s and h, raw num‖den and divided, with the
    same dropout seed: the same (edge, head) pairs are dropped."""
    g, jg = _graphs(3)
    H, C, seed = 3, 4, 5
    d, s, h, proj, proj_raw = _node_inputs(4, g.num_nodes, H, C)
    proj = proj_raw if raw_out else proj
    jop = JPacked(np.asarray(gat_dense_adj(jg)), window=128, tile=128)
    want, want_grads = _jax_vjp(
        lambda d, s, h: jop(d, s, h, float(seed), rate=rate,
                            raw_out=raw_out), d, s, h, proj)
    got, grads = _port_vjp(_port_op(g), d, s, h, proj, seed, rate, raw_out)
    _close(got, want, 2e-2)
    for a, b in zip(grads, want_grads):
        # tensor-level relative L2 within 5e-2, as tests/test_packed_gat.py
        # gates the JAX op's gradients: its bf16 rounding is heavy-tailed
        # where a sum cancels (2-4% in L2 here, one dd element off by 7% of
        # the largest); the port's gradients are held to the fp32 path at
        # 1e-4 below. Dropout bits that disagreed would move the forward
        # by O(1).
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 5e-2 * np.linalg.norm(b)


def _jax_sparse_gat(senders, receivers, n, H, C, slope=0.2):
    """fp32 segment-softmax attention over an explicit edge list, in the
    JAX package's ops (the aggregation of its sparse GATConv path)."""
    sj, rj = jnp.asarray(senders), jnp.asarray(receivers)

    def fn(d, s, h):
        z = jax.nn.leaky_relu(jnp.take(s, sj, axis=0)
                              + jnp.take(d, rj, axis=0), slope)
        alpha = jseg.segment_softmax(z, rj, n)
        msgs = jnp.take(h.reshape(n, H, C), sj, axis=0) * alpha[..., None]
        return jseg.segment_sum(msgs, rj, n).reshape(n, H * C)
    return fn


@pytest.mark.parametrize("H,C", [(3, 4), (1, 7)])
def test_packed_flash_gat_matches_jax_sparse_fp32(H, C):
    g, _ = _graphs(5)
    senders, receivers = gat_edge_set(g)
    d, s, h, proj, _ = _node_inputs(6, g.num_nodes, H, C)
    want, want_grads = _jax_vjp(
        _jax_sparse_gat(senders, receivers, g.num_nodes, H, C), d, s, h,
        proj)
    got, grads = _port_vjp(_port_op(g), d, s, h, proj, 0, 0.0, False)
    _close(got, want, 1e-5)
    for a, b in zip(grads, want_grads):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_plain_backward_is_the_vjp_of_the_plain_forward(rate):
    """The op's gradients (``packed_gat_bwd_plain``, the backward kernels'
    reference, which holds the shift constant) against autograd through
    ``packed_gat_fwd_plain`` and the division, where the shift cancels:
    the backward math of the kernels, dropout on and off."""
    g, _ = _graphs(7)
    op = _port_op(g)
    H, C = 2, 5
    n = g.num_nodes
    d, s, h, proj, _ = [torch.from_numpy(a) for a in
                        _node_inputs(8, n, H, C)]
    seed = torch.tensor([77], dtype=torch.int32)
    ins = [t.clone().requires_grad_() for t in (d, s, h)]
    m = pg.receiver_max(op.fwd, s)
    acc = pg.packed_gat_fwd_plain(op.fwd, *ins, m, seed, rate)
    num, den = acc[:, :H * C].reshape(n, H, C), acc[:, H * C:]
    want = (num / den[:, :, None]).reshape(n, H * C)
    (want * proj).sum().backward()
    _, grads = _port_vjp(op, d.numpy(), s.numpy(), h.numpy(), proj.numpy(),
                         seed, rate, False)
    for a, t in zip(grads, ins):
        _close(a, t.grad.numpy(), 1e-5)
    if rate:   # about 60% of the (edge, head) pairs dropped
        full = pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed, 0.0)
        assert not torch.allclose(acc[:, :H * C], full[:, :H * C])
        _close(acc[:, H * C:], full[:, H * C:].numpy(), 1e-6)  # den undropped


def _hub_graphs(seed=0, n=200, hub=3):
    """:func:`_arrays` at ``n`` nodes with every node sending to ``hub``
    as well: a receiver row of about ``n`` edges beside rows of ~4."""
    arrays = _arrays(seed, n=n, e=700)
    ei = np.concatenate([arrays["edge_index"],
                         np.stack([np.arange(n), np.full(n, hub)])], axis=1)
    arrays["edge_index"] = np.unique(ei, axis=1)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


@pytest.mark.parametrize("rate", [0.0, 0.6])
@pytest.mark.parametrize("H,C", [(8, 8), (1, 7), (3, 5), (4, 16), (2, 40)])
def test_packed_gat_fwd_wrapper_matches_jax_at_the_design_widths(H, C, rate):
    """``packed_gat_fwd`` on the CPU (the plain version that the CUDA
    forward is held to on the card) against the JAX ``PackedFlashGat``'s
    raw num‖den (its Pallas kernel in interpret mode), with the same
    dropout seed, at a width of each branch of the CUDA forward's
    dispatch: the row map with float4 heads (8, 8) and (4, 16), with one
    channel a lane (1, 7), and with heads that do not divide the lanes
    (3, 5); the wide-head map past 32 channels a head (2, 40). The graph
    has a receiver of ~200 senders. Its num‖den is at
    each receiver's own shift, so it is taken to the JAX operator's global
    one (``global_shift_scale``) before the comparison; its ``m`` is
    ``receiver_max``'s. 2e-2 of the largest magnitude: the JAX op rounds
    its gathers to bf16."""
    g, jg = _hub_graphs(11)
    seed = 5
    d, s, h, _, _ = _node_inputs(12, g.num_nodes, H, C)
    jop = JPacked(np.asarray(gat_dense_adj(jg)), window=128, tile=128)
    want = jop(d, s, h, float(seed), rate=rate, raw_out=True)
    op = _port_op(g)
    rows = op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]
    assert int(rows.max()) >= 200
    ts = [torch.from_numpy(a) for a in (d, s, h)]
    before = pg.packed_gat_fwd.launches
    got, m = pg.packed_gat_fwd(op.fwd, *ts,
                               torch.tensor([seed], dtype=torch.int32), rate,
                               op.slope)
    assert got.shape == (g.num_nodes, H * C + H)
    assert pg.packed_gat_fwd.launches == before
    assert torch.equal(m, pg.receiver_max(op.fwd, ts[1]))
    scale = pg.global_shift_scale(ts[0], ts[1], m, op.slope)
    got = torch.cat([(got[:, :H * C].reshape(-1, H, C)
                      * scale[:, :, None]).reshape(-1, H * C),
                     got[:, H * C:] * scale], dim=1)
    _close(got, want, 2e-2)


def test_cpu_wrappers_compute_plain_and_count_no_launch():
    g, _ = _graphs(9)
    op = _port_op(g)
    d, s, h, _, gacc = [torch.from_numpy(a) for a in
                        _node_inputs(9, g.num_nodes, 2, 3)]
    seed = torch.tensor([3], dtype=torch.int32)
    fwd0, bwd0 = pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches
    out, m = pg.packed_gat_fwd(op.fwd, d, s, h, seed, 0.6)
    assert torch.equal(m, pg.receiver_max(op.fwd, s))
    assert torch.equal(out,
                       pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed, 0.6))
    for a, b in zip(
            pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed,
                              gacc, 0.6),
            pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, gacc, 0.6)):
        assert torch.equal(a, b)
    assert (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches) == (
        fwd0, bwd0)


def test_wrappers_refuse_bad_inputs_and_other_devices():
    g, _ = _graphs(9)
    op = _port_op(g)
    n = g.num_nodes
    d, s, h = torch.zeros(n, 2), torch.zeros(n, 2), torch.zeros(n, 6)
    m, seed = torch.zeros(n, 2), torch.zeros(1, dtype=torch.int32)
    g8 = torch.zeros(n, 8)
    with pytest.raises(ValueError):
        pg.packed_gat_fwd(op.fwd, d, s, torch.zeros(n, 5), seed)
    with pytest.raises(ValueError, match="one shift a receiver"):
        pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h,
                          torch.zeros(2), seed, g8)
    with pytest.raises(TypeError):
        pg.packed_gat_fwd(op.fwd, d, s, h, seed.long())
    with pytest.raises(TypeError):
        pg.packed_gat_fwd(op.fwd, d.double(), s, h, seed)
    with pytest.raises(TypeError):
        pg.packed_gat_fwd(op.fwd, d, s, h.t().contiguous().t(), seed)
    with pytest.raises(TypeError):
        pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m.double(),
                          seed, g8)
    with pytest.raises(ValueError):
        pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed,
                          torch.zeros(n, 7))
    with pytest.raises(TypeError):
        pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid.long(), d, s, h, m,
                          seed, torch.zeros(n, 8))
    meta = [t.to("meta") for t in (d, s, h, seed)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        pg.packed_gat_fwd(op.fwd.to("meta"), *meta)


# ---------------------------------------------------------------------------
# GATConv and the example's GAT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["sparse", "packed"])
@pytest.mark.parametrize("heads,concat", [(3, True), (2, False)])
def test_gat_conv_paths_match_jax_sparse(path, heads, concat):
    g, jg = _graphs(10)
    jconv = JGATConv(5, heads=heads, concat=concat)
    params = jconv.init(jax.random.PRNGKey(1), jg, jg.x)
    conv = GATConv(F_IN, 5, heads=heads, concat=concat)
    conv.load_state_dict(params_from_jax(params))
    want = jconv.apply(params, jg, jg.x)
    got = conv(g, g.x, flash_op=_port_op(g) if path == "packed" else None)
    _close(got, want, 1e-5)


def test_gat_conv_raw_out_matches_jax_packed():
    g, jg = _graphs(11)
    jop = JPacked(np.asarray(gat_dense_adj(jg)), window=128, tile=128)
    jconv = JGATConv(5, heads=2, raw_out=True)
    params = jconv.init(jax.random.PRNGKey(2), jg, jg.x, flash_op=jop)
    conv = GATConv(F_IN, 5, heads=2, raw_out=True)
    conv.load_state_dict(params_from_jax(params))   # bias created
    got = conv(g, g.x, flash_op=_port_op(g))
    assert got.shape == (g.num_nodes, 2 * 5 + 2)
    _close(got, jconv.apply(params, jg, jg.x, flash_op=jop), 2e-2)
    with pytest.raises(ValueError, match="fused"):
        conv(g, g.x)


def test_gat_params_from_jax_layout():
    _, jg = _graphs(12)
    params = JGAT(num_classes=CLASSES).init(jax.random.PRNGKey(0), jg, jg.x)
    sd = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "conv1.weight": (F_IN, 64), "conv1.att_src": (1, 8, 8),
        "conv1.att_dst": (1, 8, 8), "conv1.bias": (64,),
        "conv2.weight": (64, CLASSES), "conv2.att_src": (1, 1, CLASSES),
        "conv2.att_dst": (1, 1, CLASSES), "conv2.bias": (CLASSES,)}
    model = tcit.GAT(F_IN, CLASSES)
    model.load_state_dict(sd)
    assert all(t.dtype == torch.float32 for t in sd.values())


def _jax_gat_loss(model, jg):
    def loss(p):
        logits = model.apply(p, jg, jg.x, train=True)
        return jcit.masked_softmax_xent(logits, jg.y, jg.train_mask), logits
    return loss


@pytest.mark.parametrize("path", ["sparse", "packed"])
def test_gat_logits_and_one_step_grads_match_jax_example(path):
    g, jg = _graphs(13)
    jmodel = JGAT(num_classes=CLASSES, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(3), jg, jg.x)
    (jl, jlogits), jgrads = jax.value_and_grad(
        _jax_gat_loss(jmodel, jg), has_aux=True)(params)
    model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    logits = model(g, g.x, train=True,
                   flash_op=_port_op(g) if path == "packed" else None)
    loss = tcit.masked_softmax_xent(logits, g.y, g.train_mask)
    loss.backward()
    _close(logits, jlogits, 1e-5)
    _close(loss, jl, 1e-5)
    want = params_from_jax(jgrads)
    for name, p in model.named_parameters():
        _close(p.grad, want[name], 1e-5)


def test_five_adamw_steps_match_jax_example():
    """``create_gat_train_step`` (the fused operator) against
    examples/gat.py's step on the sparse path (optax
    ``adamw(5e-3, weight_decay=5e-4)``), dropout off."""
    g, jg = _graphs(14)
    jmodel = JGAT(num_classes=CLASSES, dropout=0.0)
    params = jmodel.init(jax.random.PRNGKey(4), jg, jg.x)
    tx = optax.adamw(5e-3, weight_decay=5e-4)
    opt = tx.init(params)
    model = tcit.GAT(F_IN, CLASSES, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    step, evaluate = tcit.create_gat_train_step(model, g)
    for _ in range(5):
        (jl, _), grads = jax.value_and_grad(
            _jax_gat_loss(jmodel, jg), has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        _close(step()["loss"], jl, 1e-4)
    want = params_from_jax(params)
    for name, p in model.state_dict().items():
        _close(p, want[name], 1e-4)
    jlogits = jmodel.apply(params, jg, jg.x)
    got = evaluate()
    for split in ("train", "val", "test"):
        acc = jcit.masked_accuracy(jlogits, jg.y, jg.extras[f"{split}_mask"])
        assert abs(float(got[f"{split}_acc"]) - float(acc)) <= 0.02, split


def test_attention_dropout_seed_is_drawn_from_the_callers_generator():
    g, _ = _graphs(15)
    op = _port_op(g)
    model = tcit.GAT(F_IN, CLASSES, generator=torch.Generator().manual_seed(0))

    def run(seed):
        return model(g, g.x, train=True, flash_op=op,
                     generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(g, g.x, flash_op=op), model(g, g.x, flash_op=op))


def test_train_gat_cpu_counts_no_launch():
    g, _ = _graphs(16)
    fwd0, bwd0 = pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches
    model, metrics = tcit.train_gat(g, num_classes=CLASSES, epochs=5,
                                    device="cpu")
    loss = metrics["curve"]["loss"]
    assert loss.shape == (5,) and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
    assert all(0.0 <= metrics[f"{k}_acc"] <= 1.0
               for k in ("train", "val", "test"))
    assert isinstance(model, tcit.GAT)
    assert (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches) == (
        fwd0, bwd0)
