"""The edge partition and the halo exchange (``parallel/partition.py``,
``parallel/fast.py``) on gloo ranks against the JAX package's functions
under ``shard_map`` on its virtual CPU mesh.

One pool of 4 gloo ranks serves every case (P = 1, 2, 4 through
``test_torch_port_rank_cases.group_of``). The partition itself is host
numpy and equal bit for bit. Forward and input gradients of
``sum(out * probe)``: 1e-5 on the fp32 paths (the generic halo SpMMs,
max, mean, ``halo_gat``, ``halo_rgcn``); the bf16 ``PartitionedSpmm``
within 2e-2 relative L2 of the JAX one (forward) and 5e-2 (``dx``), and
its remote term's ``dx`` alone within 1e-2 of an fp32 reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as PS

import test_torch_port_rank_cases as cases
from pytorch_geometric_tpu.parallel import make_mesh as j_make_mesh
from pytorch_geometric_tpu.parallel import partition as jpt
from pytorch_geometric_tpu.parallel.fast import (
    PartitionedSpmm as JPartitionedSpmm)
from pytorch_geometric_tpu_torch.parallel.mesh import RankPool
from pytorch_geometric_tpu_torch.parallel.partition import (
    GraphShards, partition_graph)

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS, CH = 3, 5


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


def _problem(seed=0, N=97, E=600, F=12):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, E)
    r = rng.integers(0, N, E)
    w = rng.normal(size=E).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    probe = np.sin(np.arange(N * F, dtype=np.float32)).reshape(N, F)
    return s, r, w, x, probe, N


def _clustered(seed=0, N=500, E=4000, F=12, communities=8):
    """tests/test_partition_fast.py's clustered graph: dense blocks."""
    rng = np.random.default_rng(seed)
    comm = np.sort(rng.integers(0, communities, N))
    src = rng.integers(0, N, E)
    intra = rng.random(E) < 0.7
    lo = np.searchsorted(comm, comm[src])
    hi = np.searchsorted(comm, comm[src], side="right")
    dst = np.where(intra, lo + (rng.random(E) * (hi - lo)).astype(np.int64),
                   rng.integers(0, N, E))
    w = rng.normal(size=E).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    probe = np.sin(np.arange(N * F, dtype=np.float32)).reshape(N, F)
    return src, dst, w, x, probe, N


def _both(s, r, N, P, **kw):
    """The port's and the JAX partition, checked equal field by field."""
    shards, w = partition_graph(s, r, N, P, **kw)
    jshards, jw = jpt.partition_graph(s, r, N, P, **kw)
    for f in GraphShards.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(shards, f)),
                                      np.asarray(getattr(jshards, f)),
                                      err_msg=f)
    for a, b in zip(w, jw):
        np.testing.assert_array_equal(a, b)
    return shards, w, jshards


def _jax_sharded(P, jshards, fn_local, inputs, probe):
    """``fn_local(inputs, tables)`` under shard_map on P devices: the
    unsharded forward and the gradients of ``psum(sum(out * probe))`` in
    each input (sharded (P, S, ...) stacks)."""
    mesh = j_make_mesh((P,), ("graph",), devices=jax.devices()[:P])
    tables = jshards.device_arrays()
    tkeys, ikeys = sorted(tables), sorted(inputs)
    n = len(ikeys)

    def body(*vals):
        ins = {k: v[0] for k, v in zip(ikeys, vals[:n])}
        t = {k: v[0] for k, v in zip(tkeys, vals[n + 1:])}
        out = fn_local(ins, t)
        return out[None], jax.lax.psum(jnp.sum(out * vals[n][0]), "graph")

    spec = PS("graph")
    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(spec,) * (n + 1 + len(tkeys)),
                      out_specs=(spec, PS()), check_vma=False)
    tvals = [tables[k] for k in tkeys]
    ivals = [jnp.asarray(jshards.shard_nodes(inputs[k])) for k in ikeys]
    pr = jnp.asarray(jshards.shard_nodes(probe))
    out = jax.jit(f)(*ivals, pr, *tvals)[0]
    grads = jax.jit(jax.grad(lambda *iv: f(*iv, pr, *tvals)[1],
                             argnums=tuple(range(n))))(*ivals)
    N = len(jshards.perm)
    return (jshards.unshard_nodes(np.asarray(out), N),
            {k: jshards.unshard_nodes(np.asarray(g), N)
             for k, g in zip(ikeys, grads)})


def _unshard(shards, res, pick, N):
    return shards.unshard_nodes(np.stack([pick(r) for r in res
                                          if r is not None]), N)


@pytest.mark.parametrize("locality", [False, True])
def test_partition_graph_is_the_jax_partition(locality):
    s, r, w, _, _, N = _problem()
    _both(s, r, N, 4, edge_weights=w, locality=locality)
    ws = np.stack([w, -w, 2 * w], 1)
    _both(s, r, N, 3, edge_weights=ws, locality=locality)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("locality", [False, True])
def test_halo_paths_match_the_jax_ones(pool, P, locality):
    """halo / boundary / allgather SpMM, max and mean: forward and dx."""
    s, r, w, x, probe, N = _problem()
    shards, w_lr, jshards = _both(s, r, N, P, edge_weights=w,
                                  locality=locality)
    res = pool.run(cases.halo_paths, P, shards, w_lr, x, probe)
    H, B = shards.halo_size, shards.boundary_size
    jfns = {
        "halo": lambda i, t: jpt.halo_spmm(i["x"], (i["wl"], i["wr"]), t,
                                           "graph", H, P),
        "boundary": lambda i, t: jpt.boundary_spmm(
            i["x"], (i["wl"], i["wr"]), t, "graph", B),
        "allgather": lambda i, t: jpt.allgather_spmm(
            i["x"], (i["wl"], i["wr"]), t, "graph"),
        "max": lambda i, t: jpt.halo_spmm_max(i["x"], t, "graph", H, P),
        "mean": lambda i, t: jpt.halo_spmm_mean(
            i["x"], (i["wl"], i["wr"]), t, "graph", H, P),
    }
    for name, fn in jfns.items():
        want, grads = _jax_sharded_w(P, jshards, fn, x, w_lr, probe)
        got = _unshard(shards, res, lambda o: o[name][0], N)
        gx = _unshard(shards, res, lambda o: o[name][1], N)
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        np.testing.assert_allclose(gx, grads, err_msg=name, **TOL)


def _jax_sharded_w(P, jshards, fn, x, w_lr, probe):
    """:func:`_jax_sharded` with the routed weights as sharded inputs
    (already (P, E) stacks) and only x's gradient."""
    mesh = j_make_mesh((P,), ("graph",), devices=jax.devices()[:P])
    tables = jshards.device_arrays()
    tkeys = sorted(tables)
    spec = PS("graph")

    def body(xs, wl, wr, pr, *tv):
        t = {k: v[0] for k, v in zip(tkeys, tv)}
        out = fn({"x": xs[0], "wl": wl[0], "wr": wr[0]}, t)
        return out[None], jax.lax.psum(jnp.sum(out * pr[0]), "graph")

    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * (4 + len(tkeys)),
                      out_specs=(spec, PS()), check_vma=False)
    tv = [tables[k] for k in tkeys]
    xs = jnp.asarray(jshards.shard_nodes(x))
    wl, wr = jnp.asarray(w_lr[0]), jnp.asarray(w_lr[1])
    pr = jnp.asarray(jshards.shard_nodes(probe))
    out = jax.jit(f)(xs, wl, wr, pr, *tv)[0]
    g = jax.jit(jax.grad(lambda v: f(v, wl, wr, pr, *tv)[1]))(xs)
    N = len(jshards.perm)
    return (jshards.unshard_nodes(np.asarray(out), N),
            jshards.unshard_nodes(np.asarray(g), N))


@pytest.mark.parametrize("locality", [False, True])
def test_halo_gat_matches_the_jax_one(pool, locality):
    """``halo_gat`` through the packed GAT (its plain version here)
    against the JAX ``halo_gat``: output and the gradients in h, a_src
    and a_dst, at P = 4."""
    P = 4
    s, r, _, _, _, N = _problem(seed=1)
    keep = s != r
    s, r = s[keep], r[keep]
    loop = np.arange(N)
    s, r = np.concatenate([s, loop]), np.concatenate([r, loop])
    shards, _, jshards = _both(s, r, N, P, locality=locality)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(N, HEADS * CH)).astype(np.float32)
    a_s = rng.normal(size=(N, HEADS)).astype(np.float32)
    a_d = rng.normal(size=(N, HEADS)).astype(np.float32)
    probe = np.cos(np.arange(N * HEADS * CH, dtype=np.float32)).reshape(
        N, HEADS * CH)
    res = pool.run(cases.halo_gat_case, P, shards, h, a_s, a_d, HEADS, probe)
    want, grads = _jax_sharded(
        P, jshards, lambda i, t: jpt.halo_gat(
            i["h"], i["a_s"], i["a_d"], t, "graph", shards.halo_size, P,
            HEADS), {"h": h, "a_s": a_s, "a_d": a_d}, probe)
    np.testing.assert_allclose(_unshard(shards, res, lambda o: o[0], N),
                               want, **TOL)
    for i, k in enumerate(("h", "a_s", "a_d")):
        got = _unshard(shards, res, lambda o: o[1][i], N)
        np.testing.assert_allclose(got, grads[k], err_msg=k, **TOL)


def test_halo_rgcn_matches_the_jax_one(pool):
    """``halo_rgcn`` (one relation-major ``spmm_csr``, its plain version
    here) against the JAX one at P = 4: output, dx, and the gradients of
    basis, comb and root summed over the ranks."""
    P, R, F, C, B = 4, 3, 6, 4, 2
    s, r, _, _, _, N = _problem(seed=3, F=F)
    rng = np.random.default_rng(4)
    et = rng.integers(0, R, len(s))
    wv = rng.random(len(s)).astype(np.float32)
    ws = np.stack([np.where(et == k, wv, 0.0) for k in range(R)], 1)
    shards, (wl, wr), jshards = _both(s, r, N, P, edge_weights=ws)
    x = rng.normal(size=(N, F)).astype(np.float32)
    basis = rng.normal(size=(B, F, C)).astype(np.float32)
    comb = rng.normal(size=(R, B)).astype(np.float32)
    root = rng.normal(size=(F, C)).astype(np.float32)
    probe = np.sin(np.arange(N * C, dtype=np.float32)).reshape(N, C)
    rel_w = [(wl[k], wr[k]) for k in range(R)]
    res = pool.run(cases.halo_rgcn_case, P, shards, rel_w, x, basis, comb,
                   root, probe)

    mesh = j_make_mesh((P,), ("graph",), devices=jax.devices()[:P])
    tables = jshards.device_arrays()
    tkeys = sorted(tables)
    spec, rep = PS("graph"), PS()

    def body(xs, wls, wrs, pr, b, c, ro, *tv):
        t = {k: v[0] for k, v in zip(tkeys, tv)}

        def local(xv, b, c, ro):
            out = jpt.halo_rgcn(xv, b, c, [(wls[0][k], wrs[0][k])
                                           for k in range(R)], t, "graph",
                                shards.halo_size, P, root=ro)
            return jnp.sum(out * pr[0]), out

        (_, out), pg = jax.value_and_grad(local, argnums=(1, 2, 3),
                                          has_aux=True)(xs[0], b, c, ro)
        total = jax.lax.psum(jnp.sum(out * pr[0]), "graph")
        return out[None], total, [jax.lax.psum(g, "graph") for g in pg]

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(spec,) * 4 + (rep,) * 3 + (spec,) * len(tkeys),
                      out_specs=(spec, rep, [rep] * 3), check_vma=False)
    tv = [tables[k] for k in tkeys]
    xs = jnp.asarray(jshards.shard_nodes(x))
    wls = jnp.asarray(np.transpose(wl, (1, 0, 2)))
    wrs = jnp.asarray(np.transpose(wr, (1, 0, 2)))
    pr = jnp.asarray(jshards.shard_nodes(probe))
    args = (wls, wrs, pr, jnp.asarray(basis), jnp.asarray(comb),
            jnp.asarray(root), *tv)
    out, _, pgrads = jax.jit(f)(xs, *args)
    gx = jax.jit(jax.grad(lambda v: f(v, *args)[1]))(xs)
    np.testing.assert_allclose(_unshard(shards, res, lambda o: o[0], N),
                               jshards.unshard_nodes(np.asarray(out), N),
                               **TOL)
    np.testing.assert_allclose(_unshard(shards, res, lambda o: o[1][0], N),
                               jshards.unshard_nodes(np.asarray(gx), N),
                               **TOL)
    for i, name in enumerate(("basis", "comb", "root")):
        got = sum(o[1][i + 1] for o in res)
        np.testing.assert_allclose(got, np.asarray(pgrads[i]),
                                   err_msg=name, **TOL)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_fast(P, jshards, wl, wr, kw, x, probe):
    op = JPartitionedSpmm(jshards, wl, wr, sparse_tile=128, **kw)
    _, consts = op.bind()
    leaves, treedef = jax.tree_util.tree_flatten(consts)
    mesh = j_make_mesh((P,), ("graph",), devices=jax.devices()[:P])
    spec = PS("graph")

    def body(xs, pr, *cv):
        c = jax.tree_util.tree_unflatten(treedef, [v[0] for v in cv])
        out = op.apply(c, xs[0], "graph")
        return out[None], jax.lax.psum(jnp.sum(out * pr[0]), "graph")

    f = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * (2 + len(leaves)),
                      out_specs=(spec, PS()), check_vma=False)
    xs = jnp.asarray(jshards.shard_nodes(x))
    pr = jnp.asarray(jshards.shard_nodes(probe))
    out = jax.jit(f)(xs, pr, *leaves)[0]
    g = jax.jit(jax.grad(lambda v: f(v, pr, *leaves)[1]))(xs)
    N = len(jshards.perm)
    return (op.num_dense_blocks, jshards.unshard_nodes(np.asarray(out), N),
            jshards.unshard_nodes(np.asarray(g), N))


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("dense_threshold", [32, 10**9])
def test_partitioned_spmm_matches_the_jax_one(pool, P, dense_threshold):
    """Forward and dx of the bf16 ``PartitionedSpmm`` against the JAX
    operator (2e-2 / 5e-2 relative L2), with the dense split on (32) and
    off, and the same dense blocks; the rows cross in bf16."""
    s, r, w, x, probe, N = _clustered()
    shards, (wl, wr), jshards = _both(s, r, N, P, edge_weights=w)
    kw = dict(window=64, dense_threshold=dense_threshold)
    res = pool.run(cases.partitioned_spmm_case, P, shards, wl, wr, kw, x,
                   probe)
    nd, want, gwant = _jax_fast(P, jshards, wl, wr, kw, x, probe)
    got = _unshard(shards, res, lambda o: o["out"], N)
    gx = _unshard(shards, res, lambda o: o["dx"], N)
    assert _rel_l2(got, want) < 2e-2
    assert _rel_l2(gx, gwant) < 5e-2
    assert max(o["dense_blocks"] for o in res if o) == nd
    if dense_threshold == 32 and P == 4:
        assert nd > 0, "the fixture should have dense blocks"
    assert {o["sent"] for o in res if o} == {"torch.bfloat16"}


def test_remote_term_gradient_alone_is_tight(pool):
    """With the local weights 0 only the remote edges carry the sum: its
    dx (the all-to-all's transpose of the bf16 cotangent) against an
    fp32 single-device A^T probe within 1e-2 relative L2, tighter than
    the JAX test's 2e-2 / 6e-2."""
    P = 4
    s, r, w, x, probe, N = _clustered(seed=3)
    shards, (wl, wr), _ = _both(s, r, N, P, edge_weights=w)
    res = pool.run(cases.partitioned_spmm_case, P, shards, np.zeros_like(wl),
                   wr, dict(window=64, dense_threshold=32), x, probe)
    gx = _unshard(shards, res, lambda o: o["dx"], N)
    inv = np.empty(N, np.int64)
    inv[shards.perm] = np.arange(N)
    S = shards.nodes_per_shard
    remote = (inv[s] // S) != (inv[r] // S)
    want = np.zeros_like(x)
    np.add.at(want, s[remote], probe[r[remote]] * w[remote][:, None])
    assert remote.any()
    assert _rel_l2(gx, want) < 1e-2


def test_stacked_transpose_is_what_the_all_to_all_delivers(pool):
    """``chip_smoke.py``'s one-process exchange, the (P, P, H, F) stack of
    the send buffers transposed on its first two axes, equals what each
    rank's gloo all-to-all delivers."""
    P = 4
    s, r, w, x, _, N = _clustered(seed=5)
    shards, (wl, wr), _ = _both(s, r, N, P, edge_weights=w)
    res = pool.run(cases.exchange_case, P, shards, wl, wr, x)
    stacked = np.stack([send for send, _ in res])        # (P, P, H, F)
    for p, (_, recv) in enumerate(res):
        np.testing.assert_array_equal(recv, stacked.transpose(1, 0, 2, 3)[p])


def test_comm_stats_count_the_padded_and_real_rows():
    rng = np.random.default_rng(5)
    N, E, F = 400, 3000, 8
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    shards, _, jshards = _both(s, r, N, 4)
    st = shards.comm_stats(F, dtype_bytes=4)
    assert st == jshards.comm_stats(F, dtype_bytes=4)
    P, H = shards.num_devices, shards.halo_size
    real = shards.halo_send_mask.sum(axis=(1, 2))
    assert st["halo_bytes_padded_per_dev"] == P * H * F * 4
    assert st["halo_bytes_real_max"] == int(real.max()) * F * 4
    rem, loc = shards.rem_mask.sum(), shards.loc_mask.sum()
    assert st["cut_fraction"] == pytest.approx(rem / (rem + loc))
