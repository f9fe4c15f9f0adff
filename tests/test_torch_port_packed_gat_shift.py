"""The packed GAT's per-receiver softmax shift, against the JAX package.

The port's ``PackedFlashGat`` shifts receiver i's logits by
``leaky(m_i + d_i)``, ``m_i`` the largest ``s`` of i's senders: exactly
i's largest logit. The JAX operator shifts by ``leaky(max(s) + d_i)``, one
max a head over all rows, so a receiver whose incoming logits all sit
more than ~87 below that shift underflows to an output of 0 there. The
graphs here lift a tenth of the nodes' ``s`` by 100-150, so that every
receiver without a lifted sender sits that far below.

- The port's GAT layer (``GATConv`` through ``PackedFlashGat``, its
  kernels' plain versions on the CPU) against the JAX ``GATConv``'s
  segment-softmax path (``flash_op=None``, whose shift is a segment max):
  1e-5 of each row's own largest magnitude, in every row; gradients finite
  and within 1e-4 of the largest magnitude.
- The JAX ``PackedFlashGat`` gives ~0 in the rows it underflows (the
  difference, documented).
- ``raw_out=True`` on a graph where nothing underflows: the JAX operator's
  values, at its global shift. The JAX operator rounds its payload to bf16
  before the one-hot sums, so it is held at 2e-2; the same function in
  the JAX package's fp32 ops (its ``_edge_keep_bits`` for the dropout) at
  1e-5, gradients 1e-4.
- ``receiver_max`` and the empty rows: m 0, outputs 0, gradients finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.nn.conv import GATConv as JGATConv
from pytorch_geometric_tpu.nn.conv import gat_dense_adj
from pytorch_geometric_tpu.ops import segment as jseg
from pytorch_geometric_tpu.ops.packed_gat import PackedFlashGat as JPacked
from pytorch_geometric_tpu.ops.packed_gat import _edge_keep_bits
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.nn.conv import GATConv, gat_edge_set
from pytorch_geometric_tpu_torch.ops import packed_gat as pg

F_IN = 6


#: ``att_src`` of channel 0, which carries x's column 0: s is lifted by
#: LIFT times it, while the messages stay O(1) (a lift carried by h
#: itself would make the gradients differences of ~125-sized terms).
LIFT = 125.0


def _lifted_graph(seed=0, n=240, e=900, frac=0.1):
    """A graph without duplicate edges and features whose column 0 is
    0.8-1.2 at a random ``frac`` of the nodes (0 elsewhere), a lift of
    100-150 in s, with the lifted nodes' ids."""
    rng = np.random.default_rng(seed)
    ei = np.unique(np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]),
                   axis=1)
    x = (0.3 * rng.normal(size=(n, F_IN))).astype(np.float32)
    lifted = rng.random(n) < frac
    x[:, 0] = np.where(lifted, rng.uniform(100, 150, n) / LIFT,
                       0).astype(np.float32)
    arrays = dict(x=x, edge_index=ei, y=np.zeros(n, np.int64))
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)), np.flatnonzero(lifted))


def _lifted_params(jconv, jg, H, C, seed=1):
    """The JAX conv's parameters, with ``s`` taking column 0 of x times
    ``LIFT`` (the lift) and ``d`` none of it: channel 0 of every head
    carries x's column 0, which only ``att_src`` reads; the bias is 0."""
    params = jax.tree_util.tree_map(np.array, jconv.init(
        jax.random.PRNGKey(seed), jg, jg.x))
    p = params["params"]
    p["weight"][0] = 0.0
    p["weight"][0, ::C] = 1.0
    p["att_src"][0, :, 0] = LIFT
    p["att_dst"][0, :, 0] = 0.0
    p["bias"][:] = 0.0
    return jax.tree_util.tree_map(jnp.asarray, params)


def _port_op(g):
    s, r = gat_edge_set(g)
    return pg.PackedFlashGat(senders=s, receivers=r, num_nodes=g.num_nodes,
                             device="cpu")


def _low_rows(g, lifted):
    """Real receivers whose senders (the self loop included) are all
    unlifted: their logits sit 100-150 below the global max of s."""
    s, r = gat_edge_set(g)
    high = np.zeros(g.num_nodes, bool)
    high[np.asarray(r)[np.isin(np.asarray(s), lifted)]] = True
    return np.flatnonzero(~high & g.real_node_mask().numpy())


@pytest.mark.parametrize("H,C", [(3, 4), (1, 7)])
def test_packed_gat_matches_segment_softmax_where_the_global_shift_underflows(
        H, C):
    g, jg, lifted = _lifted_graph()
    jconv = JGATConv(C, heads=H)
    params = _lifted_params(jconv, jg, H, C)
    conv = GATConv(F_IN, C, heads=H)
    conv.load_state_dict(params_from_jax(params))
    op = _port_op(g)
    proj = np.random.default_rng(2).normal(
        size=(g.num_nodes, H * C)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jconv.apply(p, jg, x) * proj)

    want = np.asarray(jconv.apply(params, jg, jg.x))
    jgrad_p, jgrad_x = jax.grad(jloss, argnums=(0, 1))(params, jg.x)
    x = g.x.clone().requires_grad_()
    got = conv(g, x, flash_op=op)
    (got * torch.from_numpy(proj)).sum().backward()
    got = got.detach().numpy()

    low = _low_rows(g, lifted)
    assert low.size > g.num_nodes // 2   # of 256 padded rows
    # every row within 1e-5 of its own largest magnitude: a row that
    # underflowed (output 0) would be off by all of it
    row_scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * row_scale + 1e-7).all()
    assert (np.abs(got[low]).max(axis=1) > 1e-3).all()
    grads = {"x": (x.grad, jgrad_x)}
    grads.update((f"{k}", (v.grad, params_from_jax(jgrad_p)[k]))
                 for k, v in conv.named_parameters())
    for name, (a, b) in grads.items():
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)

    # the JAX operator, same layer: its global shift empties those rows
    jop = JPacked(np.asarray(gat_dense_adj(jg)), window=128, tile=128)
    jpacked = np.asarray(jconv.apply(params, jg, jg.x, flash_op=jop))
    assert np.abs(jpacked[low]).max() < 1e-6


def _jax_raw_global_shift(senders, receivers, n, H, C, seed, rate,
                          slope=0.2):
    """The JAX operator's raw num‖den in the JAX package's fp32 ops: the
    shift leaky(max(s) + d_i), a constant to the gradient as in the
    operator's backward kernels, the dropout of its
    ``_edge_keep_bits`` on the edge's index, num from the dropped
    weights, den from the undropped ones."""
    sj, rj = jnp.asarray(senders), jnp.asarray(receivers)
    eid = jnp.arange(sj.shape[0], dtype=jnp.int32)[:, None]
    hd = jnp.arange(H, dtype=jnp.int32)[None]
    thresh = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    keep = (_edge_keep_bits(jnp.asarray(seed, jnp.int32), eid, hd)
            >= jnp.uint32(thresh)).astype(jnp.float32)
    ks = keep / (1.0 - rate) if rate else jnp.ones_like(keep)

    def fn(d, s, h):
        z = jax.nn.leaky_relu(s[sj] + d[rj], slope)
        shift = jax.lax.stop_gradient(jax.nn.leaky_relu(
            jnp.max(s, axis=0)[None] + d[rj], slope))
        ex = jnp.exp(z - shift)
        num = h.reshape(n, H, C)[sj] * (ex * ks)[..., None]
        msg = jnp.concatenate([num.reshape(-1, H * C), ex], axis=1)
        return jseg.segment_sum(msg, rj, n)
    return fn


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_raw_out_is_the_jax_operators_num_den(rate):
    """On a graph where nothing underflows (s and d of N(0, 1)): the
    port's ``raw_out`` against the JAX operator's (2e-2, its bf16 payload)
    and against the same function in fp32 JAX ops (1e-5; gradients of d,
    s and h 1e-4)."""
    g, jg, _ = _lifted_graph(3)
    n, H, C, seed = g.num_nodes, 2, 5, 7
    rng = np.random.default_rng(4)
    d, s, h = (rng.normal(size=shape).astype(np.float32)
               for shape in ((n, H), (n, H), (n, H * C)))
    proj = rng.normal(size=(n, H * C + H)).astype(np.float32)
    senders, receivers = gat_edge_set(g)
    ref = _jax_raw_global_shift(np.asarray(senders), np.asarray(receivers),
                                n, H, C, seed, rate)
    want = np.asarray(ref(d, s, h))
    want_grads = jax.grad(lambda *a: jnp.sum(ref(*a) * proj),
                          argnums=(0, 1, 2))(d, s, h)
    ts = [torch.from_numpy(a).requires_grad_() for a in (d, s, h)]
    got = _port_op(g)(*ts, seed, rate=rate, raw_out=True)
    (got * torch.from_numpy(proj)).sum().backward()
    got = got.detach().numpy()
    assert (want[:, H * C:].max(axis=1) > 1e-3).all()   # none underflows
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for a, b in zip(ts, want_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    jop = JPacked(np.asarray(gat_dense_adj(jg)), window=128, tile=128)
    jraw = np.asarray(jop(d, s, h, float(seed), rate=rate, raw_out=True))
    np.testing.assert_allclose(got, jraw, rtol=2e-2,
                               atol=2e-2 * np.abs(jraw).max())


def test_receiver_max_and_rows_without_edges():
    """``receiver_max`` is each receiver's largest sender s (numpy), 0 for
    a row without edges; there the forward gives num‖den 0, the layer an
    output of 0 and finite gradients, and every row with an edge has den
    of at least 1 (its largest logit's exp is 1), also at a spread of 150
    between rows."""
    rng = np.random.default_rng(5)
    n, H, C = 64, 2, 3
    senders = rng.integers(0, n, 300)
    receivers = np.sort(rng.integers(0, n - 8, 300))   # rows n-8.. empty
    op = pg.PackedFlashGat(senders=senders, receivers=receivers,
                           num_nodes=n, device="cpu")
    d = torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32))
    s = torch.from_numpy((rng.normal(size=(n, H))
                          + 150 * (np.arange(n) % 7 == 0)[:, None]).astype(
                              np.float32))
    h = torch.from_numpy(rng.normal(size=(n, H * C)).astype(np.float32))
    want = np.zeros((n, H), np.float32)
    for i in range(n):
        if (receivers == i).any():
            want[i] = s.numpy()[senders[receivers == i]].max(axis=0)
    m = pg.receiver_max(op.fwd, s)
    np.testing.assert_array_equal(m.numpy(), want)
    acc, m2 = pg.packed_gat_fwd(op.fwd, d, s, h,
                                torch.tensor([1], dtype=torch.int32), 0.6)
    assert torch.equal(m, m2)
    has_edges = np.isin(np.arange(n), receivers)
    assert (acc[~has_edges] == 0).all()
    assert (acc[has_edges, H * C:] >= 1).all()
    ts = [t.clone().requires_grad_() for t in (d, s, h)]
    out = op(*ts, 1, rate=0.6)
    out.sum().backward()
    assert (out[~has_edges] == 0).all()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
