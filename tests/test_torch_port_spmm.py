"""Port parity, SpMM: the CSR build, the plain ``spmm``, and
``SpmmOperator`` (``__call__`` forward, ``dx``, ``dw``; ``bind`` forward
and ``dx``) against the JAX ``SpmmOperator`` run as its own tests run it
on the CPU (Pallas interpret mode, ``window=64``, ``tile=128``).

Tolerances: fp32 1e-5 relative to the largest reference magnitude; with
bf16 compute 1e-2, because the JAX kernel rounds each weighted message
to bf16 before its fp32 sum while the port keeps products in fp32.
The graphs hold duplicate edges (they sum) and rows with no edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.ops.spmm import SpmmOperator as JSpmmOperator
from pytorch_geometric_tpu.ops.spmm import spmm as j_spmm
from pytorch_geometric_tpu_torch.ops.csr import build_csr
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, spmm, spmm_csr, spmm_csr_plain)

N, E, F = 256, 2048, 12
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def _graph(seed=0, n=N, e=E):
    """Edges into rows [0, n - 40) only (the last 40 rows are empty),
    with the first 64 edges repeated (duplicates)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e - 64)
    r = rng.integers(0, n - 40, e - 64)
    s = np.concatenate([s, s[:64]]).astype(np.int32)
    r = np.concatenate([r, r[:64]]).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    g = rng.normal(size=(n, F)).astype(np.float32)
    return s, r, w, x, g


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _dense(s, r, w, n=N):
    a = np.zeros((n, n))
    np.add.at(a, (r, s), w)
    return a


def test_build_csr_groups_rows_and_keeps_duplicates():
    s, r, w, x, _ = _graph()
    csr = build_csr(r, s, N)
    rp, col, perm = (csr.row_ptr.numpy(), csr.col.numpy(),
                     csr.perm.numpy())
    assert csr.row_ptr.dtype == torch.int32 and col.dtype == np.int32
    assert rp[0] == 0 and rp[-1] == E and (np.diff(rp) >= 0).all()
    np.testing.assert_array_equal(np.diff(rp), np.bincount(r, minlength=N))
    assert (np.diff(rp)[-40:] == 0).all()                # empty rows
    assert sorted(perm.tolist()) == list(range(E))      # every edge once
    np.testing.assert_array_equal(col, s[perm])
    rows = np.repeat(np.arange(N), np.diff(rp))
    np.testing.assert_array_equal(rows, r[perm])
    # stable: within a row, positions keep the original edge order
    for row in range(0, N, 17):
        seg = perm[rp[row]:rp[row + 1]]
        assert (np.diff(seg) > 0).all()
    t = build_csr(s, r, N)                               # the transpose
    np.testing.assert_array_equal(np.diff(t.row_ptr.numpy()),
                                  np.bincount(s, minlength=N))


def test_build_csr_long_rows_and_validation():
    r = np.concatenate([np.full(300, 5), np.arange(50), np.full(129, 9)])
    s = np.arange(479) % 50
    csr = build_csr(r, s, 50)
    rp = csr.row_ptr.numpy()
    assert (rp[6] - rp[5], rp[10] - rp[9]) == (301, 130)
    # a long row's positions are one contiguous run, in edge order
    np.testing.assert_array_equal(csr.perm.numpy()[rp[5]:rp[6]],
                                  np.flatnonzero(r == 5))
    assert build_csr(np.arange(0), np.arange(0), 4).row_ptr.tolist() == \
        [0] * 5
    with pytest.raises(ValueError):
        build_csr(np.array([0, 50]), np.array([0, 1]), 50)
    with pytest.raises(ValueError):
        build_csr(np.array([0, 1]), np.array([0, -1]), 50)


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_spmm_csr_plain_matches_dense(direction, x_dtype):
    """The CPU wrapper in both CSR directions, fp32 out for bf16 x."""
    s, r, w, x, _ = _graph(1)
    rows, cols = (r, s) if direction == "fwd" else (s, r)
    csr = build_csr(rows, cols, N)
    val = torch.from_numpy(w)[csr.perm]
    xt = torch.from_numpy(x)
    if x_dtype == "bf16":
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()
    want = _dense(cols, rows, w) @ x
    got = spmm_csr(csr, val, xt)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    _close(spmm_csr_plain(csr, val, xt), want, 1e-5)


def test_plain_spmm_matches_jax():
    s, r, w, x, _ = _graph(2)
    got = spmm(torch.from_numpy(s), torch.from_numpy(r),
               torch.from_numpy(x), N, weights=torch.from_numpy(w))
    want = j_spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(x), N,
                  weights=jnp.asarray(w))
    _close(got, want, 1e-5)


def _jax_op(s, r, compute):
    return JSpmmOperator(s, r, N, window=64, tile=128,
                         compute_dtype=(jnp.bfloat16 if compute == "bf16"
                                        else jnp.float32))


def _port_op(s, r, compute):
    return SpmmOperator(s, r, N, device="cpu",
                        compute_dtype=(torch.bfloat16 if compute == "bf16"
                                       else torch.float32))


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_spmm_operator_call_fwd_and_grads_match_jax(compute):
    s, r, w, x, g = _graph(3)
    jop, op = _jax_op(s, r, compute), _port_op(s, r, compute)

    def jloss(w_, x_):
        return jnp.sum(jop(w_, x_) * jnp.asarray(g))

    want = jop(jnp.asarray(w), jnp.asarray(x))
    jdw, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w),
                                               jnp.asarray(x))
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = op(wt, xt)
    (out * torch.from_numpy(g)).sum().backward()
    tol = TOL[compute]
    _close(out, want, tol)
    _close(xt.grad, jdx, tol)
    _close(wt.grad, jdw, tol)
    # against the dense product as well: dx = A^T g, dw_e = <g[r], x[s]>
    a = _dense(s, r, w)
    _close(out, a @ x, tol)
    _close(xt.grad, a.T @ g, tol)
    _close(wt.grad, (g[r] * x[s]).sum(-1), tol)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_spmm_operator_bind_fwd_and_dx_match_jax(compute):
    s, r, w, x, g = _graph(4)
    jop, op = _jax_op(s, r, compute), _port_op(s, r, compute)
    jf = jop.bind(jnp.asarray(w))
    want = jf(jnp.asarray(x))
    jdx = jax.grad(lambda x_: jnp.sum(jf(x_) * jnp.asarray(g)))(
        jnp.asarray(x))
    f = op.bind(torch.from_numpy(w))
    xt = torch.from_numpy(x).requires_grad_()
    out = f(xt)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, want, TOL[compute])
    _close(xt.grad, jdx, TOL[compute])
    assert out.dtype == torch.float32 and xt.grad.dtype == torch.float32


def test_spmm_operator_bind_gives_no_weight_grad():
    s, r, w, x, _ = _graph(5)
    op = _port_op(s, r, "fp32")
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    op.bind(wt)(xt).sum().backward()
    assert wt.grad is None and xt.grad is not None
