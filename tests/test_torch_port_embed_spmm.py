"""Port parity, ``ops/embed_spmm.py``: ``EmbedSpmm`` (forward and ``d
table``, with and without weights, ids that repeat and rows that receive
nothing) and ``RgcnBasisSpmm`` (forward, ``dxB`` and ``datt``, in the
embedding mode, where the sources are the rows of a table and the
receivers another set, and in the transform mode) against the JAX
operators on the same numpy inputs. On the CPU each runs its kernel's
plain version and counts no launch. Tolerances, relative to the largest
reference magnitude: fp32 1e-5 forward, 1e-4 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.ops.embed_spmm import EmbedSpmm as JEmbedSpmm
from pytorch_geometric_tpu.ops.embed_spmm import (
    RgcnBasisSpmm as JBasisSpmm)
from pytorch_geometric_tpu_torch.ops import embed_spmm, packed_rgcn, spmm
from pytorch_geometric_tpu_torch.ops.embed_spmm import (
    EmbedSpmm, RgcnBasisSpmm)


def _close(got, want, tol):
    got = got.detach().numpy()
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("weighted,sorted_hint", [(True, False),
                                                  (False, True)])
def test_embed_spmm_matches_jax(weighted, sorted_hint):
    rng = np.random.default_rng(0)
    T, n_out, E, C = 50, 30, 400, 7
    ids = rng.integers(0, T - 5, E)          # the last rows gather nothing
    recv = np.sort(rng.integers(0, n_out - 3, E)) if sorted_hint \
        else rng.integers(0, n_out - 3, E)
    w = rng.normal(size=E).astype(np.float32) if weighted else None
    table = rng.normal(size=(T, C)).astype(np.float32)
    proj = rng.normal(size=(n_out, C)).astype(np.float32)
    jop = JEmbedSpmm(ids, recv, T, n_out, weights=w,
                     indices_are_sorted=sorted_hint)
    jout, vjp = jax.vjp(jop, jnp.asarray(table))
    (jdt,) = vjp(jnp.asarray(proj))
    op = EmbedSpmm(ids, recv, T, n_out, weights=w,
                   indices_are_sorted=sorted_hint, device="cpu")
    before = spmm.spmm_csr.launches
    t = torch.from_numpy(table).requires_grad_()
    out = op(t)
    (out * torch.from_numpy(proj)).sum().backward()
    assert out.shape == (n_out, C)
    _close(out, jout, 1e-5)
    _close(t.grad, jdt, 1e-4)
    assert spmm.spmm_csr.launches == before
    assert op.geom.fwd.num_edges == E and op.geom.bwd.num_rows == T


def _basis_case(mode, seed=1):
    """``(senders, receivers, edge_type, weights, xB, att, num_nodes,
    num_src_rows)``: in ``"embed"`` mode the senders index a table of 40
    rows, some past it (both operators clip them), and there are 25
    receivers; in ``"transform"`` mode one set of 36 nodes."""
    rng = np.random.default_rng(seed)
    R, B, C, E = 5, 3, 4, 300
    n_out, n_src = (25, 40) if mode == "embed" else (36, 36)
    s = rng.integers(0, n_src + (4 if mode == "embed" else 0), E)
    r = rng.integers(0, n_out, E)
    et = rng.integers(0, R, E)
    w = rng.random(E).astype(np.float32)
    xB = rng.normal(size=(n_src, B * C)).astype(np.float32)
    att = rng.normal(size=(R, B)).astype(np.float32)
    return s, r, et, w, xB, att, n_out, n_src


@pytest.mark.parametrize("mode", ["embed", "transform"])
def test_rgcn_basis_spmm_matches_jax(mode):
    s, r, et, w, xB, att, n_out, n_src = _basis_case(mode)
    R = att.shape[0]
    proj = np.random.default_rng(2).normal(
        size=(n_out, xB.shape[1] // att.shape[1])).astype(np.float32)
    jop = JBasisSpmm(s, r, et, R, n_out, w, num_src_rows=n_src)
    jout, vjp = jax.vjp(jop, jnp.asarray(xB), jnp.asarray(att))
    jdxB, jdatt = vjp(jnp.asarray(proj))
    op = RgcnBasisSpmm(s, r, et, R, n_out, w, num_src_rows=n_src,
                       device="cpu")
    before = (packed_rgcn.packed_rgcn_fwd.launches,
              packed_rgcn.packed_rgcn_bwd.launches)
    txB = torch.from_numpy(xB).requires_grad_()
    tatt = torch.from_numpy(att).requires_grad_()
    out = op(txB, tatt)
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out, jout, 1e-5)
    _close(txB.grad, jdxB, 1e-4)
    _close(tatt.grad, jdatt, 1e-4)
    assert (packed_rgcn.packed_rgcn_fwd.launches,
            packed_rgcn.packed_rgcn_bwd.launches) == before


def test_rgcn_basis_spmm_is_the_packed_operator():
    """The reference's name for the port's one relational operator: no
    second copy of the plain math."""
    assert embed_spmm.RgcnBasisSpmm is packed_rgcn.PackedRgcnSpmm
