"""Port parity: the static and bipartite SpMM forms of ``ops/spmm.py``.

- ``pack_bipartite_tables`` / ``spmm_bi_static`` against the JAX package's
  (Pallas interpret mode, ``window=64``, ``tile=128``), on rectangular
  operators both ways round (more source rows than destination rows and
  fewer), with duplicate edges and empty rows: forward and ``dx``. In
  fp32 1e-5 of the largest reference magnitude; with the bf16 default
  2e-2 forward and 5e-2 in relative L2 for ``dx`` (the JAX kernel rounds
  its messages to bf16, the port only x).
- ``SpmmOperator.bind_external`` / ``spmm_static`` against the JAX
  operator's, the same way.
- The geometry: each direction's CSR, one ``spmm_csr`` per direction, a
  forward-only operator, and the checks of its shapes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.ops.csr import build_csr

# by module path: both packages' ``ops`` re-export a function ``spmm``
jspmm = importlib.import_module("pytorch_geometric_tpu.ops.spmm")
tspmm = importlib.import_module("pytorch_geometric_tpu_torch.ops.spmm")

F = 9
JAX_KW = dict(window=64, tile=128)
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _edges(n_src, n_dst, e=900, seed=0):
    """Edges into the first ``n_dst - 20`` destination rows (the last 20
    are empty), the first 40 repeated."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_src, e - 40)
    r = rng.integers(0, n_dst - 20, e - 40)
    s = np.concatenate([s, s[:40]])
    r = np.concatenate([r, r[:40]])
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n_src, F)).astype(np.float32)
    g = rng.normal(size=(n_dst, F)).astype(np.float32)
    return s, r, w, x, g


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_fwd_dx(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return out, xt.grad


def _jax_fwd_dx(fn, x, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    return out, dx


def _check(port, want, dtype):
    (out, dx), (want_out, want_dx) = port, want
    if dtype == "fp32":
        _close(out, want_out, 1e-5)
        _close(dx, want_dx, 1e-5)
    else:
        _close(out, want_out, 2e-2)
        assert _rel_l2(dx, want_dx) <= 5e-2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n_src,n_dst", [(300, 130), (130, 300)])
def test_spmm_bi_static_matches_jax(n_src, n_dst, dtype):
    s, r, w, x, g = _edges(n_src, n_dst)
    tdt, jdt = DTYPES[dtype]
    geom, consts = tspmm.pack_bipartite_tables(
        s, r, n_src, n_dst, w, compute_dtype=tdt, device="cpu")
    jgeom, jconsts = jspmm.pack_bipartite_tables(
        s, r, n_src, n_dst, w, compute_dtype=jdt, **JAX_KW)
    assert (geom.n_src, geom.n_dst) == (jgeom.n_src, jgeom.n_dst)
    assert geom.compute == jgeom.compute
    port = _port_fwd_dx(lambda x: tspmm.spmm_bi_static(geom, consts, x),
                        x, g)
    want = _jax_fwd_dx(lambda x: jspmm.spmm_bi_static(jgeom, jconsts, x),
                       x, g)
    assert tuple(port[0].shape) == (n_dst, F) and port[0].dtype == \
        torch.float32
    assert tuple(port[1].shape) == (n_src, F)
    _check(port, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bind_external_and_spmm_static_match_jax(dtype):
    n = 200
    s, r, w, x, g = _edges(n, n, seed=1)
    tdt, jdt = DTYPES[dtype]
    fn, consts = tspmm.SpmmOperator(s, r, n, compute_dtype=tdt,
                                    device="cpu").bind_external(w)
    jfn, jconsts = jspmm.SpmmOperator(s, r, n, compute_dtype=jdt,
                                      **JAX_KW).bind_external(w)
    geom = fn.args[0]
    assert isinstance(geom, tspmm.SpmmGeom) and fn.func is tspmm.spmm_static
    assert geom.num_nodes == jfn.args[0].num_nodes == n
    assert geom.compute == jfn.args[0].compute
    port = _port_fwd_dx(lambda x: fn(consts, x), x, g)
    want = _jax_fwd_dx(lambda x: jfn(jconsts, x), x, g)
    _check(port, want, dtype)


def test_bipartite_geometry_is_the_csr_and_its_transpose():
    n_src, n_dst = 70, 40
    s, r, w, x, _ = _edges(n_src, n_dst, e=200, seed=2)
    geom, consts = tspmm.pack_bipartite_tables(
        s, r, n_src, n_dst, w, compute_dtype=torch.float32, device="cpu")
    want_f, want_b = build_csr(r, s, n_dst, n_src), build_csr(s, r, n_src,
                                                              n_dst)
    for csr, want, val in ((geom.fwd, want_f, consts["fwd"]),
                           (geom.bwd, want_b, consts["bwd"])):
        assert torch.equal(csr.row_ptr, want.row_ptr)
        assert torch.equal(csr.col, want.col)
        assert torch.equal(val, torch.from_numpy(w)[want.perm])
    dense = np.zeros((n_dst, n_src))
    np.add.at(dense, (r, s), w)
    out = tspmm.spmm_bi_static(geom, consts, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), dense @ x, rtol=1e-5,
                               atol=1e-5)
    # the plain versions on the CPU: no kernel launch
    before = tspmm.spmm_csr.launches
    tspmm.spmm_bi_static(geom, consts, torch.from_numpy(x))
    assert tspmm.spmm_csr.launches == before


def test_forward_only_operator_and_shape_checks():
    n_src, n_dst = 50, 30
    s, r, w, x, _ = _edges(n_src, n_dst, e=120, seed=3)
    geom, consts = tspmm.pack_bipartite_tables(
        s, r, n_src, n_dst, w, compute_dtype=torch.float32,
        directions=("fwd",), device="cpu")
    assert geom.bwd is None and set(consts) == {"fwd"}
    out = tspmm.spmm_bi_static(geom, consts, torch.from_numpy(x))
    assert tuple(out.shape) == (n_dst, F)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="forward direction only"):
        tspmm.spmm_bi_static(geom, consts, xt).sum().backward()
    with pytest.raises(ValueError, match="x must be"):
        tspmm.spmm_bi_static(geom, consts, torch.zeros(n_dst, F))
    with pytest.raises(ValueError, match="expected 31 x 50"):
        tspmm.BiSpmmGeom.make(geom.fwd, None, n_src, n_dst + 1, "f32")
    with pytest.raises(ValueError, match="compute"):
        tspmm.BiSpmmGeom.make(geom.fwd, None, n_src, n_dst, "fp16")
    with pytest.raises(TypeError, match="compute_dtype"):
        tspmm.pack_bipartite_tables(s, r, n_src, n_dst, w,
                                    compute_dtype=torch.float16,
                                    device="cpu")
