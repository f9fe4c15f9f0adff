"""Port parity, RGCN slice: the ``Entities`` dataset and its collation,
``rgcn_norm``, the fused operator (``PackedRgcnSpmm`` through its
kernels' plain versions on the CPU), ``RGCNConv`` on every full-graph
path, the ``RGCN``
of examples/rgcn.py and its Adam steps, against the JAX package run as
its own tests run it on the CPU (Pallas interpret mode, ``window=64,
tile=128``).

Tolerances, relative to the largest reference magnitude:

- exact for the dataset and the collated graph;
- fp32 1e-5 forward and 1e-4 for gradients and five Adam steps against
  the JAX fp32 paths (``RgcnBasisSpmm``, the plain ``RGCNConv`` paths,
  the example's ``Net``); 1e-6 for ``rgcn_norm``;
- 2e-2 forward and 3e-2 for gradients against the JAX ``PackedRgcnSpmm``,
  which rounds ``xB``, ``att`` and the incoming gradient to bf16 for its
  one-hot matrix products: that gap is the JAX kernel's rounding, not a
  fault of either side.

The graphs hold duplicate edges (each counts, as in ``rgcn_norm``), nodes
without in-edges and, once padded, padding nodes and edges.
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
from pytorch_geometric_tpu.datasets import Entities as JEntities
from pytorch_geometric_tpu.nn.conv import RGCNConv as JRGCNConv
from pytorch_geometric_tpu.nn.conv.rgcn_conv import rgcn_fused_op as j_fused_op
from pytorch_geometric_tpu.nn.conv.rgcn_conv import rgcn_norm as j_rgcn_norm
from pytorch_geometric_tpu.ops.embed_spmm import RgcnBasisSpmm as JBasisSpmm
from pytorch_geometric_tpu.ops.packed_rgcn import PackedRgcnSpmm as JPacked
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.datasets import Entities
from pytorch_geometric_tpu_torch.models import entities as tent
from pytorch_geometric_tpu_torch.nn.conv import (
    RGCNConv, rgcn_fused_op, rgcn_norm)
from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from examples.rgcn import Net as JNet  # noqa: E402

R = 6


def _arrays(seed=0, n=90, e=400):
    """Typed multigraph: duplicate (sender, receiver, relation) triples,
    and the last five nodes receive nothing."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 5, e)])
    et = rng.integers(0, R, e)
    ei[:, :12], et[:12] = ei[:, 12:24], et[12:24]
    return dict(edge_index=ei, edge_type=et, num_nodes=n)


def _graphs(seed=0, **kw):
    arrays = _arrays(seed, **kw)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _edge_lists(g):
    """Real edges of a collated graph with their mean-norm weights."""
    real = g.edge_mask.numpy()
    w = rgcn_norm(g, g.edge_type, R).numpy()
    return (g.senders.numpy()[real], g.receivers.numpy()[real],
            g.edge_type.numpy()[real], w[real])


def _randomised(params, seed):
    """The same tree with every leaf redrawn (so zero-initialised biases
    take part)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(scale=0.3, size=a.shape)
                              .astype(np.float32)), params)


# ---------------------------------------------------------------------------
# dataset and collation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,scale", [("MUTAG", 0.02), ("MUTAG", 0.001),
                                        ("AIFB", 0.05)])
def test_entities_synthetic_matches_jax_exactly(tmp_path, name, scale):
    ds = Entities(str(tmp_path / "port"), name, scale=scale)
    jds = JEntities(str(tmp_path / "jax"), name, scale=scale)
    assert ds.is_synthetic
    assert (ds.num_relations, ds.num_classes) == (jds.num_relations,
                                                  jds.num_classes)
    d, jd = ds[0], jds[0]
    assert sorted(d.keys) == sorted(jd.keys)
    for key in d.keys:
        assert d[key].dtype == jd[key].dtype, key
        np.testing.assert_array_equal(d[key], jd[key], err_msg=key)
    assert (d.num_nodes, d.num_edges) == (jd.num_nodes, jd.num_edges)
    assert (d.y[d.train_idx] >= 0).all() and (d.y == -1).any()


def test_entities_from_data_matches_jax_graph(tmp_path):
    """Labels of -1, ``num_nodes_hint``, int64 -> int32, the padding, and
    ``edge_type`` reordered with the receiver-sorted edges."""
    d = Entities(str(tmp_path / "port"), "MUTAG", scale=0.02)[0]
    jd = JEntities(str(tmp_path / "jax"), "MUTAG", scale=0.02)[0]
    g, jg = from_data(d, device="cpu"), j_from_data(jd)
    assert (g.num_nodes, g.num_edges, g.num_graphs) == (
        jg.num_nodes, jg.num_edges, jg.num_graphs) == (512, 3072, 2)
    for field in ("senders", "receivers", "y", "node_mask", "edge_mask",
                  "batch"):
        got, want = getattr(g, field).numpy(), np.asarray(getattr(jg, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert sorted(g.extras) == sorted(jg.extras)
    for key, want in jg.extras.items():
        got, want = g.extras[key].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert g.edges_sorted and (np.diff(g.receivers.numpy()) >= 0).all()
    # the trainer's default split: row 0 of the stacked per-graph field
    np.testing.assert_array_equal(g.extras["train_idx"][0].numpy(),
                                  d.train_idx)


def test_entities_full_scale_has_the_published_shapes(tmp_path):
    ds = Entities(str(tmp_path), "MUTAG", scale=1.0)
    d = ds[0]
    assert (d.num_nodes, d.num_edges) == (23644, 141864)
    assert int(d.edge_type.max()) + 1 == ds.num_relations == 46
    assert len(d.train_idx) + len(d.test_idx) == 340
    g = from_data(d, device="cpu")
    assert (g.num_nodes, g.num_edges) == (24576, 196608)
    assert not os.listdir(tmp_path)       # nothing is written under root


def test_entities_reads_npz_and_rejects_unknown_names(tmp_path):
    src = Entities(str(tmp_path / "a"), "AIFB", scale=0.05)[0]
    raw = tmp_path / "b" / "entities" / "aifb" / "raw"
    raw.mkdir(parents=True)
    np.savez(raw / "aifb.npz", **{k: src[k] for k in src.keys})
    ds = Entities(str(tmp_path / "b"), "AIFB")
    assert not ds.is_synthetic
    for key in src.keys:
        np.testing.assert_array_equal(ds[0][key], src[key])
    with pytest.raises(ValueError, match="unknown entity corpus"):
        Entities(str(tmp_path), "BGS")


def test_rgcn_norm_matches_jax():
    g, jg = _graphs(1)
    got = rgcn_norm(g, g.edge_type, R)
    want = j_rgcn_norm(jg, jg.extras["edge_type"], R)
    _close(got, want, 1e-6)
    assert float(got[~g.edge_mask].abs().max()) == 0.0
    assert 0.0 < float(got[g.edge_mask].min()) and float(got.max()) == 1.0


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _op_inputs(seed, rows, n, B, C):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((rows, B * C), (R, B), (n, C))]


def _port_vjp(op, xB, att, proj):
    ts = [torch.from_numpy(a).requires_grad_() for a in (xB, att)]
    out = op(*ts)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def _jax_vjp(op, xB, att, proj):
    def loss(xB, att):
        return jnp.sum(op(xB, att) * proj)
    return op(xB, att), jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(xB), jnp.asarray(att))


@pytest.mark.parametrize("src_rows,B,C", [(None, 3, 4), (70, 5, 2),
                                          (None, 4, 16)])
def test_fused_operators_match_jax_basis_spmm(src_rows, B, C):
    """The port's operator (plain versions, fp32) against the JAX
    package's fp32 operator. Transform mode (source rows = nodes) and embed mode (fewer source
    rows than nodes, so senders are clipped), forward and both
    gradients."""
    g, _ = _graphs(2)
    s, r, et, w = _edge_lists(g)
    n = g.num_nodes
    rows = n if src_rows is None else src_rows
    xB, att, proj = _op_inputs(3, rows, n, B, C)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=src_rows,
                           device="cpu")
    jop = JBasisSpmm(s, r, et, R, n, w, num_src_rows=src_rows)
    out, grads = _port_vjp(op, xB, att, proj)
    jout, jgrads = _jax_vjp(jop, xB, att, proj)
    assert out.shape == (n, C) and grads[0].shape == (rows, B * C)
    _close(out, jout, 1e-5)
    for got, want in zip(grads, jgrads):
        _close(got, want, 1e-4)
    assert float(out[n - 5:].abs().max()) == 0.0      # rows without edges


@pytest.mark.parametrize("src_rows,B,C", [(None, 3, 4), (70, 3, 4)])
def test_packed_operator_matches_jax_packed_kernels(src_rows, B, C):
    """Against the JAX Pallas kernels in interpret mode. They round xB,
    att and g to bf16; the port's fp32 result sits within that rounding
    (2e-2 forward, 3e-2 gradients), as the JAX package's own test gates
    its packed backend against its fp32 one."""
    g, _ = _graphs(4)
    s, r, et, w = _edge_lists(g)
    n = g.num_nodes
    rows = n if src_rows is None else src_rows
    xB, att, proj = _op_inputs(5, rows, n, B, C)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=src_rows,
                           device="cpu")
    jop = JPacked(s, r, et, R, n, w, num_src_rows=src_rows, window=64,
                  tile=128)
    out, grads = _port_vjp(op, xB, att, proj)
    jout, jgrads = _jax_vjp(jop, xB, att, proj)
    _close(out, jout, 2e-2)
    for got, want in zip(grads, jgrads):
        _close(got, want, 3e-2)


@pytest.mark.parametrize("B,C", [(3, 4), (5, 33), (30, 2)])
def test_plain_backward_is_the_gradient_of_plain_forward(B, C):
    """The hand-derived backward, which the kernels are held to on the
    card, pinned against autograd of the forward without a card."""
    g, _ = _graphs(6)
    s, r, et, w = _edge_lists(g)
    n, rows = g.num_nodes, 75
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device="cpu")
    xB, att, proj = (torch.from_numpy(a)
                     for a in _op_inputs(7, rows, n, B, C))
    xB.requires_grad_(), att.requires_grad_()
    out = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    want = torch.autograd.grad(out, (xB, att), proj)
    got = pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w,
                                   xB.detach(), att.detach(), proj)
    for a, b in zip(got, want):
        _close(a, b.numpy(), 1e-5)


def test_relation_major_positions_index_the_same_edges():
    """``bwd_pos`` sends each sender-major edge to its slot in
    relation-major order, and ``rel_ptr`` bounds each relation there: the
    layout the datt reduction walks on the card."""
    g, _ = _graphs(8)
    s, r, et, w = _edge_lists(g)
    op = pr.PackedRgcnSpmm(s, r, et, R, g.num_nodes, w, device="cpu")
    pos = op.bwd_pos.numpy()
    assert sorted(pos) == list(range(op.E))
    by_rel = np.empty(op.E, np.int64)
    by_rel[pos] = op.bwd_et.numpy()
    ptr = op.rel_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == op.E
    for rel in range(R):
        assert (by_rel[ptr[rel]:ptr[rel + 1]] == rel).all()
    # both CSRs carry the same multiset of (sender, receiver, relation)
    fwd_rows = pr._rows_of(op.fwd).numpy()
    bwd_rows = pr._rows_of(op.bwd).numpy()
    a = sorted(zip(op.fwd.col.tolist(), fwd_rows, op.fwd_et.tolist()))
    b = sorted(zip(bwd_rows, op.bwd.col.tolist(), op.bwd_et.tolist()))
    assert a == b == sorted(zip(s, r, et))


def test_receiver_positions_index_the_same_edges():
    """``fwd_pos`` sends each sender-major edge to the receiver-major
    slot of the same (sender, receiver, relation, weight): where the
    forward's message walk stores each edge's message for the receivers'
    segment sum."""
    g, _ = _graphs(8)
    s, r, et, w = _edge_lists(g)
    op = pr.PackedRgcnSpmm(s, r, et, R, g.num_nodes, w, num_src_rows=70,
                           device="cpu")
    pos = op.fwd_pos.numpy()
    assert op.send.pos is op.fwd_pos and op.send.csr is op.bwd
    assert sorted(pos) == list(range(op.E))
    fwd_rows = pr._rows_of(op.fwd).numpy()
    bwd_rows = pr._rows_of(op.bwd).numpy()
    fwd_cols = op.fwd.col.numpy()
    np.testing.assert_array_equal(fwd_cols[pos], bwd_rows)        # sender
    np.testing.assert_array_equal(fwd_rows[pos], op.bwd.col.numpy())
    np.testing.assert_array_equal(op.fwd_et.numpy()[pos], op.bwd_et.numpy())
    np.testing.assert_array_equal(op.fwd_w.numpy()[pos], op.bwd_w.numpy())
    # duplicate edges exist, and each takes a slot of its own
    assert len(set(zip(bwd_rows, op.bwd.col.tolist()))) < op.E


def _hub_lists(g):
    """``_edge_lists`` plus 300 edges into receiver 3, each with weight
    1/300, so one receiver row is ten times the longest other."""
    s, r, et, w = _edge_lists(g)
    rng = np.random.default_rng(21)
    extra = 300
    return (np.concatenate([s, rng.integers(0, 70, extra)]),
            np.concatenate([r, np.full(extra, 3)]),
            np.concatenate([et, rng.integers(0, R, extra)]),
            np.concatenate([w, np.full(extra, 1 / extra, np.float32)]))


@pytest.mark.parametrize("case,src_rows,B,C", [
    ("multigraph", None, 3, 4), ("hub", None, 5, 33),
    ("hub", 70, 30, 2), ("multigraph", 70, 4, 16)])
def test_cpu_forward_runs_the_two_plain_phases(monkeypatch, case, src_rows,
                                               B, C):
    """On CPU tensors ``packed_rgcn_fwd`` runs the card's two phases in
    plain PyTorch: each edge's message from the sender-major CSR at its
    receiver-major position (``packed_rgcn_messages_plain``), then the
    receivers' sums (``sorted_segment_sum_plain``). The result agrees
    with the one-phase ``packed_rgcn_fwd_plain`` (1e-6) and with the JAX
    packed forward (2e-2, its bf16 rounding), with a hub receiver, rows
    without in-edges, and fewer source rows than nodes (embed mode)."""
    g, _ = _graphs(4)
    s, r, et, w = _hub_lists(g) if case == "hub" else _edge_lists(g)
    n = g.num_nodes
    rows = n if src_rows is None else src_rows
    xB, att, _ = _op_inputs(5, rows, n, B, C)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=src_rows,
                           device="cpu")
    calls = []
    for name in ("packed_rgcn_messages_plain", "sorted_segment_sum_plain"):
        fn = getattr(pr, name)
        monkeypatch.setattr(pr, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    pr.packed_rgcn_fwd.launches = 0
    out = pr.packed_rgcn_fwd(op.fwd, op.send, torch.from_numpy(xB),
                             torch.from_numpy(att))
    assert calls == ["packed_rgcn_messages_plain",
                     "sorted_segment_sum_plain"]
    assert pr.packed_rgcn_fwd.launches == 0
    want = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w,
                                    torch.from_numpy(xB),
                                    torch.from_numpy(att))
    _close(out, want.numpy(), 1e-6)
    assert float(out[n - 5:].abs().max()) == 0.0      # rows without edges
    lengths = (op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]).numpy()
    assert (int(lengths.argmax()), int(lengths.max()) > 300) == (
        (3, True) if case == "hub" else (int(lengths.argmax()), False))
    jop = JPacked(s, r, et, R, n, w, num_src_rows=src_rows, window=64,
                  tile=128)
    _close(out, jop(jnp.asarray(xB), jnp.asarray(att)), 2e-2)


def test_packed_wrappers_refuse_bad_inputs_and_other_devices():
    g, _ = _graphs(9)
    s, r, et, w = _edge_lists(g)
    n = g.num_nodes
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, device="cpu")
    xB, att = torch.ones(n, 6), torch.ones(R, 3)
    args = (op.fwd, op.send)
    with pytest.raises(ValueError, match="rows"):
        pr.packed_rgcn_fwd(*args, torch.ones(n - 1, 6), att)
    with pytest.raises(ValueError, match="B\\*C"):
        pr.packed_rgcn_fwd(*args, torch.ones(n, 7), att)
    with pytest.raises(TypeError):
        pr.packed_rgcn_fwd(*args, xB.double(), att)
    with pytest.raises(TypeError):
        pr.packed_rgcn_fwd(op.fwd, op.send._replace(et=op.bwd_et.long()),
                           xB, att)
    with pytest.raises(TypeError):
        pr.packed_rgcn_fwd(op.fwd, op.send._replace(pos=op.fwd_pos.long()),
                           xB, att)
    meta = pr.SenderCsr(op.bwd.to("meta"), op.bwd_et.to("meta"),
                        op.bwd_w.to("meta"), op.fwd_pos.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        pr.packed_rgcn_fwd(op.fwd.to("meta"), meta, xB.to("meta"),
                           att.to("meta"))
    # the forward needs the sender-major CSR of the same edges
    with pytest.raises(TypeError, match="SenderCsr"):
        pr.packed_rgcn_fwd(op.fwd, (op.bwd, op.bwd_et, op.bwd_w), xB, att)
    fewer = pr.PackedRgcnSpmm(s[1:], r[1:], et[1:], R, n, w[1:],
                              device="cpu")
    with pytest.raises(ValueError, match="sender-major CSR of the same"):
        pr.packed_rgcn_fwd(op.fwd, fewer.send, xB, att)
    with pytest.raises(ValueError, match="pos must be"):
        pr.packed_rgcn_fwd(op.fwd, op.send._replace(pos=op.fwd_pos[1:]),
                           xB, att)
    with pytest.raises(ValueError, match="g must be"):
        pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                           op.rel_ptr, xB, att, torch.ones(n, 3))
    with pytest.raises(ValueError, match="edge_type out of range"):
        pr.PackedRgcnSpmm(s, r, et, R - 1, n, w, device="cpu")
    # empty shapes, for which a kernel would not be launched
    with pytest.raises(ValueError, match="at least one relation"):
        pr.packed_rgcn_fwd(*args, xB, torch.ones(0, 3))
    none = pr.PackedRgcnSpmm(s[:0], r[:0], et[:0], R, 0, w[:0],
                             num_src_rows=n, device="cpu")
    with pytest.raises(ValueError, match="at least one relation"):
        pr.packed_rgcn_fwd(none.fwd, none.send, xB, att)


# ---------------------------------------------------------------------------
# RGCNConv
# ---------------------------------------------------------------------------

def _conv_pair(in_channels, out_channels, num_bases, jg, jx, seed, **kw):
    """A JAX conv with random parameters and the port's conv carrying
    them."""
    jconv = JRGCNConv(in_channels, out_channels, R, num_bases=num_bases,
                      **kw)
    jet = jg.extras["edge_type"]
    params = _randomised(jconv.init(jax.random.PRNGKey(seed), jg, jx, jet),
                         seed)
    conv = RGCNConv(in_channels, out_channels, R, num_bases=num_bases,
                    generator=torch.Generator().manual_seed(seed), **kw)
    state = params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in conv.state_dict().items()}
    conv.load_state_dict(state)
    return conv, jconv, params


def _conv_check(conv, jconv, params, g, jg, x, port_kw, jax_kw, proj):
    jet = jg.extras["edge_type"]
    jx = None if x is None else jnp.asarray(x)
    tx = None if x is None else torch.from_numpy(x)
    out = conv(g, tx, **port_kw)
    (out * torch.from_numpy(proj)).sum().backward()
    want = jconv.apply(params, jg, jx, jet, **jax_kw)
    _close(out, want, 1e-5)
    jgrads = jax.grad(lambda p: jnp.sum(
        jconv.apply(p, jg, jx, jet, **jax_kw) * proj))(params)
    for name, want in params_from_jax(jgrads).items():
        _close(dict(conv.named_parameters())[name].grad, want.numpy(), 1e-4)
    conv.zero_grad()


# (in_channels or None for the embedding mode, out_channels, num_bases)
_PLAIN_PATHS = [
    pytest.param(None, 4, 3, id="embedding"),
    pytest.param(None, 4, 0, id="embedding-no-bases"),
    pytest.param(16, 4, 3, id="transform-first"),
    pytest.param(16, 4, 0, id="transform-first-no-bases"),
    pytest.param(4, 8, 3, id="aggregate-first"),
    pytest.param(4, 8, 0, id="aggregate-first-no-bases"),
]


@pytest.mark.parametrize("f_in,C,num_bases", _PLAIN_PATHS)
def test_rgcn_conv_plain_paths_match_jax(f_in, C, num_bases):
    g, jg = _graphs(11)
    n = g.num_nodes
    rng = np.random.default_rng(12)
    x = None if f_in is None else rng.normal(size=(n, f_in)).astype(
        np.float32)
    proj = rng.normal(size=(n, C)).astype(np.float32)
    conv, jconv, params = _conv_pair(
        n if f_in is None else f_in, C, num_bases, jg,
        None if x is None else jnp.asarray(x), 13)
    # with and without a precomputed norm, edge_type from the graph
    _conv_check(conv, jconv, params, g, jg, x, {}, {}, proj)
    norm = rgcn_norm(g, g.edge_type, R)
    jnorm = j_rgcn_norm(jg, jg.extras["edge_type"], R)
    _conv_check(conv, jconv, params, g, jg, x,
                dict(edge_type=g.edge_type, norm=norm), dict(norm=jnorm),
                proj)


def test_rgcn_conv_without_root_and_bias_matches_jax():
    g, jg = _graphs(14)
    n = g.num_nodes
    rng = np.random.default_rng(15)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    proj = rng.normal(size=(n, 4)).astype(np.float32)
    conv, jconv, params = _conv_pair(16, 4, 3, jg, jnp.asarray(x), 16,
                                     root_weight=False, use_bias=False)
    assert sorted(conv.state_dict()) == ["att", "basis"]
    _conv_check(conv, jconv, params, g, jg, x, {}, {}, proj)


@pytest.mark.parametrize("mode", ["embed", "transform"])
def test_rgcn_conv_fused_paths_match_jax(mode):
    """The fused operator path against the JAX conv's plain path (fp32)
    and against the JAX conv on its own fp32 fused operator."""
    g, jg = _graphs(17)
    n, C = g.num_nodes, 4
    rng = np.random.default_rng(18)
    x = None if mode == "embed" else rng.normal(size=(n, 16)).astype(
        np.float32)
    proj = rng.normal(size=(n, C)).astype(np.float32)
    conv, jconv, params = _conv_pair(
        n if mode == "embed" else 16, C, 3, jg,
        None if x is None else jnp.asarray(x), 19)
    op = rgcn_fused_op(g, g.edge_type, R, mode, in_channels=n)
    assert isinstance(op, pr.PackedRgcnSpmm)
    assert op.E == int(g.edge_mask.sum())     # padding edges are dropped
    jop = j_fused_op(jg, jg.extras["edge_type"], R, mode, in_channels=n)
    _conv_check(conv, jconv, params, g, jg, x, dict(fused_op=op), {}, proj)
    _conv_check(conv, jconv, params, g, jg, x, dict(fused_op=op),
                dict(fused_op=jop), proj)


def test_rgcn_fused_op_rejects_unknown_modes():
    g, _ = _graphs(20)
    with pytest.raises(ValueError, match="mode"):
        rgcn_fused_op(g, None, R, "closure")
    with pytest.raises(ValueError, match="in_channels"):
        rgcn_fused_op(g, None, R, "embed")


# ---------------------------------------------------------------------------
# the slice: examples/rgcn.py's Net, its gradients and its Adam steps
# ---------------------------------------------------------------------------

def _slice(tmp_path, seed=21):
    d = Entities(str(tmp_path / "port"), "MUTAG", scale=0.004)[0]
    jd = JEntities(str(tmp_path / "jax"), "MUTAG", scale=0.004)[0]
    g, jg = from_data(d, device="cpu"), j_from_data(jd)
    Rm = 46
    jnet = JNet(num_nodes=jg.num_nodes, num_relations=Rm, num_classes=2)
    jet = jg.extras["edge_type"]
    params = _randomised(jnet.init(jax.random.PRNGKey(seed), jg, jet), seed)
    model = tent.RGCN(g.num_nodes, Rm, 2,
                      generator=torch.Generator().manual_seed(seed))
    state = params_from_jax(params)
    assert sorted(state) == sorted(model.state_dict()) == sorted(
        f"conv{i}.{p}" for i in (1, 2)
        for p in ("att", "basis", "bias", "root"))
    model.load_state_dict(state)
    return d, g, jg, model, jnet, params


def _jax_loss_fn(jnet, jg, d):
    jet = jg.extras["edge_type"]
    norm = j_rgcn_norm(jg, jet, 46)
    train_idx = jnp.asarray(d.train_idx)

    def loss_fn(p):   # examples/rgcn.py:77-83
        logp = jax.nn.log_softmax(jnet.apply(p, jg, jet, norm))
        sel = jnp.take(logp, train_idx, axis=0)
        lab = jnp.take(jg.y, train_idx).astype(jnp.int32)
        return -jnp.mean(jnp.take_along_axis(sel, lab[:, None], axis=1))
    return loss_fn


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_rgcn_logits_and_one_step_gradients_match_the_jax_example(
        tmp_path, fused):
    d, g, jg, model, jnet, params = _slice(tmp_path)
    fused = tent.rgcn_fused_ops(g, 46) if fused else None
    logits = model(g, fused_ops=fused)
    want = jnet.apply(params, jg, jg.extras["edge_type"])
    assert logits.shape == (g.num_nodes, 2)
    _close(logits, want, 1e-5)
    idx = torch.from_numpy(d.train_idx)
    loss = tent.softmax_xent_int_labels(logits[idx],
                                        g.y[idx].long()).mean()
    loss.backward()
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jnet, jg, d))(params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(model.named_parameters())
    for name, want in params_from_jax(jgrads).items():
        _close(grads[name].grad, want.numpy(), 1e-4)


def test_five_adam_steps_match_optax(tmp_path):
    d, g, jg, model, jnet, params = _slice(tmp_path, seed=22)
    loss_fn = _jax_loss_fn(jnet, jg, d)
    tx = optax.adam(0.01)
    opt = tx.init(params)
    want = []
    for _ in range(5):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    # the split comes from the graph itself, as train_rgcn takes it
    step, _ = tent.create_rgcn_train_step(model, g, 46)
    got = [float(step()["loss"]) for _ in range(5)]
    _close(np.asarray(got, np.float32), want, 1e-4)
    assert want[-1] < want[0]
    for name, ref in params_from_jax(params).items():
        _close(dict(model.named_parameters())[name], ref.numpy(), 1e-4)


def test_train_rgcn_learns_on_the_cpu_without_a_launch(tmp_path):
    g = from_data(Entities(str(tmp_path), "MUTAG", scale=0.01)[0],
                  device="cpu")
    pr.packed_rgcn_fwd.launches = pr.packed_rgcn_bwd.launches = 0
    model, metrics = tent.train_rgcn(g, 46, 2, epochs=30, seed=3,
                                     device="cpu")
    loss = metrics["curve"]["loss"]
    assert loss.shape == (30,) and np.isfinite(loss).all()
    assert loss[-1] < 0.5 * loss[0] and metrics["train_acc"] >= 0.9
    assert sorted(metrics) == ["curve", "seconds", "test_acc", "train_acc"]
    assert (pr.packed_rgcn_fwd.launches, pr.packed_rgcn_bwd.launches) == (
        0, 0)
    # the trained model's fused path against its plain path
    with torch.no_grad():
        _close(model(g, fused_ops=tent.rgcn_fused_ops(g, 46)), model(g),
               1e-5)
