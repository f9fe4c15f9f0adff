"""Port parity, the scale SpMM operators: ``HybridSpmm``
(``ops/hybrid_spmm.py``), ``BlockStructure`` / ``BlockSpmm``
(``ops/block_spmm.py``) and the GCN trainer's ``backend="hybrid"``
against the JAX package (Pallas in interpret mode) on the same numpy
inputs, at small windows, mirroring ``tests/test_block_spmm.py`` and
``tests/test_gcn_cora.py:46``.

Tolerances, relative to the largest reference magnitude: fp32 1e-5
(gradients 1e-4); against the operators that round to bf16, 2e-2, and
5e-2 in relative L2 for gradients. Where both packages round to bf16
they round at different points: the JAX SpMM kernel rounds each dense
message ``w_e x[s_e]`` to bf16 before it sums (``ops/spmm.py:87``), the
port's ``spmm_csr`` only x; the JAX block table rounds each edge weight
to bf16 before it sums duplicates, the port the sum. So bf16 parity is
held to 2e-2, not bitwise."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.ops import block_spmm as jblock
from pytorch_geometric_tpu.ops.hybrid_spmm import HybridSpmm as JHybridSpmm
from pytorch_geometric_tpu.ops.spmm import SpmmOperator as JSpmmOperator
from pytorch_geometric_tpu.ops.spmm import spmm as j_spmm
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models import citation as tcit
from pytorch_geometric_tpu_torch.ops import block_spmm as tblock
from pytorch_geometric_tpu_torch.ops.hybrid_spmm import HybridSpmm
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
#: forward, gradient (relative L2 where bf16) tolerances
TOL = {"fp32": (1e-5, 1e-4), "bf16": (2e-2, 5e-2)}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype=np.float32)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _close_l2(got, want, tol):
    got, want = _np(got), np.asarray(want, dtype=np.float32)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _grad_close(got, want, name):
    if name == "fp32":
        _close(got, want, TOL[name][1])
    else:
        _close_l2(got, want, TOL[name][1])


def _problem(seed=0, n=200, f=24, dense=600, scattered=400):
    """Half the edges in one (32, 32) corner, the rest anywhere (the JAX
    test's problem)."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, 32, dense),
                        rng.integers(0, n, scattered)])
    r = np.concatenate([rng.integers(0, 32, dense),
                        rng.integers(0, n, scattered)])
    w = rng.normal(size=s.shape[0]).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    return s, r, w, x, g, n


def _jax_grads(fn, w, x, g):
    """``(out, dw, dx)`` of ``sum(fn(w, x) * g)``."""
    out, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(x))
    dw, dx = vjp(jnp.asarray(g))
    return out, dw, dx


def _port_grads(fn, w, x, g):
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = fn(wt, xt)
    dw, dx = torch.autograd.grad(out, (wt, xt), torch.tensor(g))
    return out, dw, dx


# ---------------------------------------------------------------------------
# HybridSpmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DTYPES))
def test_hybrid_spmm_matches_jax_with_grads(name):
    tdt, jdt = DTYPES[name]
    s, r, w, x, g, n = _problem(1)
    jop = JHybridSpmm(s, r, n, window=32, tile=128, compute_dtype=jdt)
    op = HybridSpmm(s, r, n, window=32, tile=128, compute_dtype=tdt,
                    device="cpu")
    assert op.dense_frac == jop.dense_frac
    assert 0.3 < op.dense_frac < 0.9 and len(op.parts) == 2
    want, jdw, jdx = _jax_grads(jop, w, x, g)
    got, dw, dx = _port_grads(op, w, x, g)
    _close(got, want, TOL[name][0])
    _grad_close(dx, jdx, name)
    _grad_close(dw, jdw, name)
    # the bound form equals the call
    with torch.no_grad():
        _close(op.bind(w)(torch.tensor(x)), got, 1e-6)


def test_hybrid_spmm_fp32_part_is_exact_and_parts_split_the_edges():
    """The sparse part sums in fp32: with a threshold no bucket meets,
    the operator is one fp32 SpMM (1e-5 against the plain sum); with
    threshold 1 every edge is dense. The dense and sparse ids partition
    the edges."""
    s, r, w, x, _, n = _problem(2)
    ref = spmm(torch.tensor(s), torch.tensor(r), torch.tensor(x), n,
               weights=torch.tensor(w))
    sparse = HybridSpmm(s, r, n, window=32, dense_threshold=10 ** 9,
                        device="cpu")
    assert sparse.dense_frac == 0.0 and len(sparse.parts) == 1
    _close(sparse(torch.tensor(w), torch.tensor(x)), ref, 1e-5)
    dense = HybridSpmm(s, r, n, window=32, dense_threshold=1,
                       device="cpu")
    assert dense.dense_frac == 1.0 and len(dense.parts) == 1
    jdense = JHybridSpmm(s, r, n, window=32, dense_threshold=1)
    _close(dense(torch.tensor(w), torch.tensor(x)),
           jdense(jnp.asarray(w), jnp.asarray(x)), 2e-2)
    mixed = HybridSpmm(s, r, n, window=32, tile=128, device="cpu")
    ids = np.sort(np.concatenate([p[1].numpy() for p in mixed.parts]))
    np.testing.assert_array_equal(ids, np.arange(len(s)))


def test_hybrid_spmm_duplicate_edges_and_masked_edges():
    """Repeated edges sum; edges outside ``edge_mask`` weigh 0 by
    contract: they count in the split (``dense_frac`` is the JAX one)
    but no operator holds them, and their weight gradient is still
    ``<g[r], x[s]>``."""
    rng = np.random.default_rng(3)
    # a dense bucket with repeated edges, two sparse edges, and three
    # masked edges that make a second bucket dense
    s = np.array([1, 1, 2, 1, 1, 9, 3, 12, 13, 15])
    r = np.array([0, 0, 3, 0, 0, 2, 10, 15, 15, 15])
    w = np.array([1.0, 2.0, 5.0, 3.0, 4.0, -1.0, 0.5, 0.0, 0.0, 0.0],
                 np.float32)
    mask = np.array([True] * 7 + [False] * 3)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    g = rng.normal(size=(16, 4)).astype(np.float32)
    jop = JHybridSpmm(s, r, 16, window=8, dense_threshold=3,
                      compute_dtype=jnp.float32)
    op = HybridSpmm(s, r, 16, window=8, dense_threshold=3,
                    compute_dtype=torch.float32, device="cpu",
                    edge_mask=mask)
    assert op.dense_frac == jop.dense_frac == 0.8
    assert [len(p[1]) for p in op.parts] == [5, 2]
    want, jdw, jdx = _jax_grads(jop, w, x, g)
    got, dw, dx = _port_grads(op, w, x, g)
    _close(got, want, 1e-5)
    _close(dx, jdx, 1e-4)
    _close(dw, jdw, 1e-4)


def test_hybrid_gcn_three_epochs_match_the_jax_pallas_trainer():
    """``create_gcn_train_step(backend="hybrid")`` against the JAX
    ``create_gcn_train_step(pallas=True)`` with the same windows, from
    the same flax parameters, dropout off: three Adam epochs' losses,
    then the parameters and the evaluation logits (bf16: 2e-2; the
    parameters 5e-2 in relative L2)."""
    rng = np.random.default_rng(4)
    n, f, classes, hidden = 60, 8, 3, 4
    ei = np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)])
    tm = np.zeros(n, bool)
    tm[:10] = True
    arrays = dict(x=rng.normal(size=(n, f)).astype(np.float32),
                  edge_index=ei, y=rng.integers(0, classes, n),
                  train_mask=tm, val_mask=tm, test_mask=tm)
    graph = from_data(Data(**arrays), device="cpu")
    jgraph = j_from_data(JData(**arrays))
    jmodel = jcit.GCN(hidden_channels=hidden, num_classes=classes,
                      dropout_rate=0.0)
    init_fn, jstep, _ = jcit.create_gcn_train_step(
        jmodel, jgraph, pallas=True, window=16, tile=128)
    params, opt_state = init_fn(jax.random.PRNGKey(0))
    model = tcit.GCN(f, hidden, classes, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    step, _ = tcit.create_gcn_train_step(model, graph, backend="hybrid",
                                         window=16, tile=128)
    agg, _ = tcit.gcn_backend(graph, "hybrid", window=16, tile=128)
    op, _ = tcit.gcn_hybrid_operator(graph, 16, 128)
    assert 0.0 < op.dense_frac < 1.0
    carry = (params, opt_state, jax.random.PRNGKey(1))
    jstep = jax.jit(jstep)
    for _ in range(3):
        carry, metrics = jstep(carry, None)
        _close(step()["loss"], metrics["loss"], 2e-2)
    want = params_from_jax(carry[0])
    for name, p in model.state_dict().items():
        _close_l2(p, want[name].numpy(), 5e-2)
    norm = tcit.gcn_norm(graph)
    jnorm = jcit.gcn_norm(jgraph)
    jop = JHybridSpmm(np.asarray(jnorm.senders), np.asarray(jnorm.receivers),
                      jgraph.num_nodes, window=16, tile=128)
    assert op.dense_frac == jop.dense_frac
    assert norm.senders.shape[0] == jnorm.senders.shape[0]
    with torch.no_grad():
        logits = model(graph, graph.x, **agg)
    jlogits = jmodel.apply(carry[0], jgraph, jgraph.x,
                           aggregate_fn=lambda h: jop(jnorm.weights, h))
    _close(logits, jlogits, 2e-2)


# ---------------------------------------------------------------------------
# BlockStructure and BlockSpmm
# ---------------------------------------------------------------------------

def _block_ops(s, r, n, w, name, **kw):
    tdt, jdt = DTYPES[name]
    kw = {"window": 32, "dense_threshold": 100, **kw}
    jop = jblock.BlockSpmm(s, r, n, w, sparse_tile=128, compute_dtype=jdt,
                           **kw)
    op = tblock.BlockSpmm(s, r, n, w, compute_dtype=tdt, device="cpu", **kw)
    return op, jop


def _block_grads(op, x, g):
    fn, consts = op.bind()
    xt = torch.tensor(x, requires_grad=True)
    out = fn(consts, xt)
    dx, = torch.autograd.grad(out, xt, torch.tensor(g))
    return out, dx


def _jax_block_grads(jop, x, g):
    fn, consts = jop.bind()
    out, vjp = jax.vjp(lambda xx: fn(consts, xx), jnp.asarray(x))
    return out, vjp(jnp.asarray(g))[0]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_block_spmm_matches_jax_with_grads(name):
    s, r, w, x, g, n = _problem(5)
    op, jop = _block_ops(s, r, n, w, name)
    assert (op.num_dense_blocks, op.sparse_edges, op.num_windows) == \
        (jop.num_dense_blocks, jop.sparse_edges, jop.num_windows)
    assert op.dense_edge_frac == jop.dense_edge_frac
    assert op.num_dense_blocks >= 1 and 0.3 < op.dense_edge_frac < 0.9
    assert op.flop_inflation == 1.0
    st, jst = op.structure, jop.structure
    np.testing.assert_array_equal(st.block_src_win.numpy(),
                                  np.asarray(jst.block_src_win))
    np.testing.assert_array_equal(st.block_dst_win.numpy(),
                                  np.asarray(jst.block_dst_win))
    np.testing.assert_array_equal(st._sparse_edge_ids,
                                  jst._sparse_edge_ids)
    blocks = st.dense_blocks(w)
    jblocks = jst.dense_blocks(w)
    assert blocks.dtype == DTYPES[name][0]
    _close(blocks.float(), np.asarray(jblocks, np.float32),
           TOL[name][0])
    want, jdx = _jax_block_grads(jop, x, g)
    got, dx = _block_grads(op, x, g)
    _close(got, want, TOL[name][0])
    _grad_close(dx, jdx, name)
    # and against the plain fp32 sum
    ref = spmm(torch.tensor(s), torch.tensor(r), torch.tensor(x), n,
               weights=torch.tensor(w))
    _close(got, ref, TOL[name][0] if name == "fp32" else 2e-2)


def test_block_spmm_duplicate_edges_sum():
    """Multigraph edges inside a dense block sum (the JAX test's case),
    in fp32 (1e-5) and bf16 (2e-2)."""
    rng = np.random.default_rng(6)
    s = np.array([1, 1, 2, 1, 1])
    r = np.array([0, 0, 3, 0, 0])
    w = np.array([1.0, 2.0, 5.0, 3.0, 4.0], np.float32)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    for name in ("fp32", "bf16"):
        op, jop = _block_ops(s, r, 8, w, name, window=8, dense_threshold=3)
        assert op.num_dense_blocks == 1 and op.sparse_edges == 0
        fn, consts = op.bind()
        jfn, jconsts = jop.bind()
        _close(fn(consts, torch.tensor(x)),
               jfn(jconsts, jnp.asarray(x)), TOL[name][0])
        assert float(consts["blocks"][0, 0, 1]) == 10.0


@pytest.mark.parametrize("threshold", [10 ** 9, 1])
def test_block_spmm_all_sparse_and_all_dense(threshold):
    s, r, w, x, g, n = _problem(7)
    op, jop = _block_ops(s, r, n, w, "fp32", dense_threshold=threshold)
    if threshold > 1:
        assert op.num_dense_blocks == 0 and op.structure.sparse is not None
    else:
        assert op.sparse_edges == 0 and op.structure.sparse is None
    want, jdx = _jax_block_grads(jop, x, g)
    got, dx = _block_grads(op, x, g)
    _close(got, want, 1e-5)
    _close(dx, jdx, 1e-4)


def test_block_structure_is_shared_between_weightings():
    """One ``BlockStructure``, two weightings (the GCN norm and the mean,
    as bench_scale.py binds them): each equal bit for bit to a
    ``BlockSpmm`` built alone, and to the JAX operator on a JAX
    structure (bf16, 2e-2)."""
    s, r, _, x, _, n = _problem(8)
    deg = np.bincount(r, minlength=n).astype(np.float64) + 1
    w_gcn = (deg[s] ** -0.5 * deg[r] ** -0.5).astype(np.float32)
    w_mean = (1.0 / deg[r]).astype(np.float32)
    st = tblock.BlockStructure(s, r, n, window=32, dense_threshold=100,
                               device="cpu")
    jst = jblock.BlockStructure(s, r, n, window=32, dense_threshold=100,
                                sparse_tile=128)
    xt = torch.tensor(x)
    for w in (w_gcn, w_mean):
        shared = tblock.BlockSpmm(s, r, n, w, structure=st)
        alone = tblock.BlockSpmm(s, r, n, w, window=32, dense_threshold=100,
                                 device="cpu")
        fn, consts = shared.bind()
        fn2, consts2 = alone.bind()
        got = fn(consts, xt)
        assert torch.equal(got, fn2(consts2, xt))
        jfn, jconsts = jblock.BlockSpmm(s, r, n, w, structure=jst).bind()
        _close(got, jfn(jconsts, jnp.asarray(x)), 2e-2)


def test_bind_external_matches_bind():
    """``SpmmOperator.bind_external`` (what the block remainder rides)
    equals ``bind`` bit for bit, and the JAX ``bind_external`` (fp32,
    1e-5; its gradient 1e-4)."""
    s, r, w, x, g, n = _problem(9)
    op = SpmmOperator(s, r, n, device="cpu")
    fn, consts = op.bind_external(w)
    xt = torch.tensor(x, requires_grad=True)
    out = fn(consts, xt)
    dx, = torch.autograd.grad(out, xt, torch.tensor(g))
    xb = torch.tensor(x, requires_grad=True)
    outb = op.bind(w)(xb)
    dxb, = torch.autograd.grad(outb, xb, torch.tensor(g))
    assert torch.equal(out, outb) and torch.equal(dx, dxb)
    jop = JSpmmOperator(s, r, n, window=32, tile=128, light=True)
    jfn, jconsts = jop.bind_external(jnp.asarray(w))
    want, vjp = jax.vjp(lambda xx: jfn(jconsts, xx), jnp.asarray(x))
    _close(out, want, 1e-5)
    _close(dx, vjp(jnp.asarray(g))[0], 1e-4)
    ref = j_spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(x), n,
                 weights=jnp.asarray(w))
    _close(out, ref, 1e-5)


def test_f32_to_bf16_is_bitwise_the_jax_rounding():
    """torch's float32 -> bfloat16 conversion against the JAX package's
    integer-view round-to-nearest-even, bit for bit: random values over
    many exponents, the ties of each rounding direction, subnormals,
    zeros and infinities."""
    rng = np.random.default_rng(10)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-40, 38, 4096)
         ).astype(np.float32)
    u = rng.integers(0, 2 ** 31, 4096).astype(np.uint32)
    ties = (u & ~np.uint32(0xFFFF)) | np.uint32(0x8000)   # exact halves
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                         1.17549435e-38, 3.3895314e38, 1.0, -1.0],
                        np.float32)
    vals = np.concatenate([a, ties.view(np.float32),
                           u.view(np.float32), specials])
    vals = vals[np.isfinite(vals) | np.isinf(vals)]
    vals = vals[~np.isnan(vals)]
    got = tblock._f32_to_bf16(vals).view(torch.int16).numpy()
    want = jblock._f32_to_bf16(vals).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert want.dtype == np.int16 and \
        jblock._f32_to_bf16(vals).dtype == ml_dtypes.bfloat16


def test_scale_operators_refuse_other_compute_types():
    s, r, w, _, _, n = _problem(11)
    with pytest.raises(TypeError, match="compute_dtype"):
        tblock.BlockStructure(s, r, n, window=32,
                              compute_dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError, match="compute_dtype"):
        HybridSpmm(s, r, n, window=32, compute_dtype=torch.float16,
                   device="cpu")


def test_adam_of_optax_and_torch_share_their_constants():
    """The hybrid trainer's parity leans on ``torch.optim.Adam`` being
    ``optax.adam``: one step on the same gradient, 1e-6."""
    p = np.linspace(-1.0, 1.0, 7).astype(np.float32)
    grad = np.cos(np.arange(7)).astype(np.float32)
    tx = optax.adam(0.01)
    updates, _ = tx.update(jnp.asarray(grad), tx.init(jnp.asarray(p)))
    want = np.asarray(optax.apply_updates(jnp.asarray(p), updates))
    t = torch.tensor(p, requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.01)
    t.grad = torch.tensor(grad)
    opt.step()
    _close(t, want, 1e-6)


def test_gen_clustered_is_bench_scales_draw_for_draw():
    """The port's copy of the scale benchmark's community graph
    (``datasets/graphs.py:gen_clustered``) against
    ``bench_scale.py:gen_clustered``, bit for bit, and its block split
    against the JAX ``BlockStructure`` at a small size."""
    import bench_scale

    from pytorch_geometric_tpu_torch.datasets.graphs import gen_clustered

    got = gen_clustered(5000, 60_000, 8, seed=3)
    want = bench_scale.gen_clustered(5000, 60_000, 8, seed=3)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    s, r, _ = got
    st = tblock.BlockStructure(s, r, 5000, window=256, dense_threshold=400,
                               device="cpu")
    jst = jblock.BlockStructure(s, r, 5000, window=256, dense_threshold=400)
    assert (st.num_dense_blocks, st.sparse_edges, st.dense_edge_frac) == \
        (jst.num_dense_blocks, jst.sparse_edges, jst.dense_edge_frac)
    assert st.dense_edge_frac > 0.8
