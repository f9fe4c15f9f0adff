"""The redesigned backwards of the dense-mask GAT (``csrc/flash_gat.cu``)
and the packed RGCN (``csrc/packed_rgcn.cu``) on the CPU, where their
wrappers compute the plain versions: against the JAX package at the
widths the design probes time, with no launch counted; and the design
probes' sources, graphs and builds (``probes/flash_gat_designs.py``,
``probes/packed_rgcn_designs.py``). Their card tests are in
``tests/test_torch_port_kernels.py``.

Tolerances, relative to the largest reference magnitude: gradients of the
JAX ``FlashGatOperator``, which rounds to bf16, within 5e-2 in relative L2
(as ``tests/test_torch_port_flash_gat.py`` holds the operator); the JAX
fp32 ``RgcnBasisSpmm`` within 1e-4 (as ``tests/test_torch_port_rgcn.py``).
"""

import ctypes
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.ops.embed_spmm import RgcnBasisSpmm as JBasisSpmm
from pytorch_geometric_tpu.ops.flash_gat import (
    FlashGatOperator as JFlashGatOperator)
from pytorch_geometric_tpu_torch.datasets import graphs
from pytorch_geometric_tpu_torch.kernels import _build
from pytorch_geometric_tpu_torch.ops import flash_gat as fg
from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr
from probes import (flash_gat_designs, packed_rgcn_designs, rgcn_ablate,
                    segment_sum_designs)

REPO = Path(__file__).resolve().parents[1]


def _flash_inputs(seed, n, H, C):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.08) | np.eye(n, dtype=bool)
    adj[3, :] = False                      # an empty row
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]
    return adj, arrays


@pytest.mark.parametrize("H,C", [(8, 8), (1, 7)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_flash_gat_bwd_wrapper_matches_jax_at_the_design_widths(H, C, rate):
    """``flash_gat_bwd`` on CPU tensors (the plain version, no launch) at
    the main path's widths, conv1's (8, 8) and conv2's (1, 7): dd, ds and
    dh against the gradients of the JAX operator's forward, with the same
    dropout seed."""
    n, seed = 72, 9
    adj, (d, s, h, proj) = _flash_inputs(H * 100 + C, n, H, C)
    jop = JFlashGatOperator(adj)

    def loss(d, s, h):
        return jnp.sum(jop(d, s, h, float(seed), rate=rate) * proj)

    want = jax.grad(loss, argnums=(0, 1, 2))(d, s, h)
    mask = fg.BitMask(torch.from_numpy(adj))
    dt, st, ht, gt = (torch.from_numpy(a) for a in (d, s, h, proj))
    seed_t = torch.tensor([seed], dtype=torch.int32)
    before = fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches
    out, lse = fg.flash_gat_fwd(mask, dt, st, ht, seed_t, rate)
    got = fg.flash_gat_bwd(mask, dt, st, ht, lse, out, gt, seed_t, rate)
    assert (fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches) == before
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 5e-2 * np.linalg.norm(b)


@pytest.mark.parametrize("B,C", [(30, 16), (30, 2), (5, 33)])
def test_packed_rgcn_bwd_wrapper_matches_jax_at_the_design_widths(B, C):
    """``packed_rgcn_bwd`` on CPU tensors (the plain version, no launch)
    at the design probe's widths (MUTAG conv1, conv2, the hub operator's):
    dxB and datt against the gradients of the JAX fp32 operator, in embed
    mode with a sender row of many edges and a dominant relation."""
    rng = np.random.default_rng(B + C)
    n, R, rows = 60, 5, 50
    s = np.concatenate([rng.integers(0, rows, 300), np.full(80, 7)])
    r = np.concatenate([rng.integers(0, n - 4, 300),
                        rng.integers(0, n, 80)])
    et = np.where(rng.random(380) < 0.7, 2, rng.integers(0, R, 380))
    w = (rng.random(380) + 0.1).astype(np.float32)
    xB, att, proj = (rng.normal(size=shape).astype(np.float32)
                     for shape in ((rows, B * C), (R, B), (n, C)))
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device="cpu")
    jop = JBasisSpmm(s, r, et, R, n, w, num_src_rows=rows)

    def loss(xB, att):
        return jnp.sum(jop(xB, att) * proj)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xB), jnp.asarray(att))
    before = pr.packed_rgcn_bwd.launches
    got = pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                             op.rel_ptr, torch.from_numpy(xB),
                             torch.from_numpy(att), torch.from_numpy(proj))
    assert pr.packed_rgcn_bwd.launches == before
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_flash_gat_designs_times_the_library_beside_its_first_design():
    """The dense-mask design probe builds through ``build_source`` from a
    source that includes the production one (so every design is the
    library's own code), launches the first design of the forward and of
    the backward and the sub-warp design with the library's signatures,
    keeps the channel map of the column pass it was measured against, and
    covers the main path's widths, dropout 0 and 0.6, the half-full mask
    and the operator's cap."""
    source = flash_gat_designs.SOURCE.read_text()
    text = Path(flash_gat_designs.__file__).read_text()
    assert "build_source(SOURCE, SIGNATURES)" in text
    assert '#include "../pytorch_geometric_tpu_torch/csrc/flash_gat.cu"' \
        in source
    for call in ("launch_fwd_heads(", "launch_row_heads(",
                 "launch_col_heads(",
                 "launch_row_lanes<16>(", "launch_col_lanes<8>(",
                 "flash_bwd_col_channels_kernel<L,"):
        assert call in source, call
    library = (_build.SOURCE_DIR / "flash_gat.cu").read_text()
    assert library.count("template <int L = kRowLanes>") == 3
    assert "const int rc = launch_fwd_lanes(a);" in library
    assert "flash_fwd_row_kernel<L, V, KC>" in library
    assert "const int rc = launch_row_lanes(a);" in library
    assert "const int rc = launch_col_lanes(a);" in library
    assert "constexpr int kRowLanes = 32;" in library
    sig = _build.SIGNATURES["flash_gat"]
    for kernel in ("row", "col"):
        assert flash_gat_designs.SIGNATURES[f"first_flash_gat_bwd_{kernel}"] \
            == sig[f"flash_gat_bwd_{kernel}"]
    assert flash_gat_designs.SIGNATURES["first_flash_gat_fwd"] \
        == sig["flash_gat_fwd"]
    assert flash_gat_designs.FWD_DESIGNS == ("first", "shipped")
    cases = flash_gat_designs.CASES
    assert {c[0] for c in cases} == {"cora", "half2048", "cap8192"}
    assert {("cora", 8, 8, 0.0), ("cora", 8, 8, 0.6), ("cora", 1, 7, 0.0),
            ("cora", 1, 7, 0.6), ("half2048", 8, 8, 0.6),
            ("cap8192", 8, 8, 0.6)} == set(cases)
    assert flash_gat_designs.designs(8, 8) == ("first", "shipped",
                                               "channels")
    assert set(flash_gat_designs.designs(1, 7)) > {"lanes8", "lanes16"}


def test_packed_rgcn_designs_times_the_library_beside_its_first_design():
    """The RGCN design probe keeps the first design of the walk in its own
    namespace, launches it and the library's walk variants with the
    library's signature (the variants' knobs before the stream), and
    covers MUTAG conv1 and conv2 and the hub operator."""
    source = packed_rgcn_designs.SOURCE.read_text()
    assert '#include "../pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu"' \
        in source
    assert "namespace first_design {" in source
    assert "first_design::rgcn_bwd_kernel<CP>" in source
    assert "rgcn_bwd_kernel<CP, 0, MB>" in source
    sig = _build.SIGNATURES["packed_rgcn"]["packed_rgcn_bwd"]
    assert packed_rgcn_designs.SIGNATURES["first_packed_rgcn_bwd"] == sig
    blocks = packed_rgcn_designs.SIGNATURES["blocks_packed_rgcn_bwd"]
    assert blocks[1][:-1] == sig[1][:-1] + [sig[1][-2]]
    library = (_build.SOURCE_DIR / "packed_rgcn.cu").read_text()
    assert "return CP >= 16 ? 3 : (CP >= 8 ? 4 : 5);" in library
    assert [c[0] for c in packed_rgcn_designs.CASES] == ["conv1", "conv2",
                                                         "hub"]
    designs = packed_rgcn_designs.all_designs()
    assert designs[:2] == ("first", "shipped")
    assert {"blocks1", "blocks3", "blocks4", "blocks5"} <= set(designs)
    # the forward: the first design over the receiver-major CSR (its CSR,
    # xB, att and out, then n_rows, B and C); the prefetch probe takes the
    # library's forward's arguments and the depth
    assert "rgcn_fwd_kernel<CP><<<" in source
    first = packed_rgcn_designs.SIGNATURES["first_packed_rgcn_fwd"]
    assert first[1] == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    pipe = rgcn_ablate.SIGNATURES["packed_rgcn_pipe_fwd"]
    fwd = _build.SIGNATURES["packed_rgcn"]["packed_rgcn_fwd"]
    assert pipe[1] == fwd[1][:-1] + [ctypes.c_int] + fwd[1][-1:]
    op = pr.PackedRgcnSpmm(np.array([0, 1]), np.array([1, 0]),
                           np.array([0, 1]), 2, 2, np.ones(2, np.float32),
                           device="cpu")
    with pytest.raises(ValueError, match="unknown forward design"):
        packed_rgcn_designs.fwd(None, "ahead", op, torch.ones(2, 6),
                                torch.ones(2, 3))


@pytest.mark.parametrize("header,libraries", [
    ("row_lanes.cuh", ["flash_gat", "bsr_gat", "packed_gat",
                       "packed_rgcn", "spmm_csr", "fused_gcn"]),
    ("gat_mask.cuh", ["flash_gat", "bsr_gat"])])
def test_build_follows_shared_headers_into_every_library(tmp_path,
                                                          monkeypatch,
                                                          header,
                                                          libraries):
    """``flash_gat.cu`` now includes ``row_lanes.cuh`` beside
    ``gat_mask.cuh``: an edit to a shared header renames the library of
    every source that includes it, and of the design probe that includes
    the source, and of no other."""
    csrc = tmp_path / "pytorch_geometric_tpu_torch" / "csrc"
    shutil.copytree(_build.SOURCE_DIR, csrc)
    (tmp_path / "probes").mkdir()
    probe = tmp_path / "probes" / flash_gat_designs.SOURCE.name
    shutil.copy(flash_gat_designs.SOURCE, probe)
    monkeypatch.setattr(_build, "SOURCE_DIR", csrc)
    assert [p.name for p in _build._included(probe)] == [
        "flash_gat_designs.cu", "flash_gat.cu", "row_lanes.cuh",
        "gat_mask.cuh"]
    names = list(_build.SIGNATURES)
    before = {name: _build.library_path(name) for name in names}
    probe_before = _build._library_of(probe)
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    changed = sorted(name for name in names
                     if _build.library_path(name) != before[name])
    assert changed == sorted(libraries)
    assert _build._library_of(probe) != probe_before


def test_flash_synthetic_masks_are_the_probes_and_chip_smokes():
    """The dense masks that ``chip_smoke.py`` and the design probe share:
    half full at 2048 nodes with three empty rows and columns, and the
    operator's cap at PubMed's degree with every self loop; one pair of
    masks for one seed."""
    (half_name, half), (cap_name, cap) = graphs.flash_synthetic_masks(0)
    assert (half_name, half.shape, cap_name, cap.shape) == (
        "half2048", (2048, 2048), "cap8192", (fg.MAX_NODES, fg.MAX_NODES))
    assert not half[[0, 77, 2047]].any() and not half[:, [5, 1000, 2046]].any()
    assert 0.45 < half.mean() < 0.55
    assert np.diagonal(cap).all() and np.array_equal(cap, cap.T)
    assert 4 < cap.sum() / cap.shape[0] < 7
    again = graphs.flash_synthetic_masks(0)
    assert np.array_equal(again[0][1], half)
    assert np.array_equal(again[1][1], cap)


def test_rgcn_hub_operator_holds_its_hub_rows():
    """The hub operator of ``chip_smoke.py``, the design probe and the
    card tests: a sender row of 2,511 edges (node 10) and a receiver row
    of 3,013 (node 3), 4,200 source rows, a dominant relation."""
    op = graphs.rgcn_hub_operator("cpu", 0)
    sent = (op.bwd.row_ptr[1:] - op.bwd.row_ptr[:-1]).numpy()
    got = (op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]).numpy()
    assert (int(sent[10]), int(sent.max())) == (2511, 2511)
    assert (int(got[3]), int(got.max())) == (3013, 3013)
    assert (op.num_src_rows, op.num_nodes, op.R, op.E) == (4200, 4096, 7,
                                                           35500)
    assert np.bincount(op.fwd_et.numpy()).argmax() == 2


def test_segment_sum_header_is_shared_by_both_of_its_libraries(
        tmp_path, monkeypatch):
    """The receiver-sorted segment sum lives in ``segment_sum.cuh``, which
    the sorted GCN's source and the RGCN forward's source both include
    (one copy of the kernel): an edit to it renames both libraries, the
    RGCN probes' libraries and the segment sum's design probe's, and no
    other."""
    csrc = tmp_path / "pytorch_geometric_tpu_torch" / "csrc"
    shutil.copytree(_build.SOURCE_DIR, csrc)
    (tmp_path / "probes").mkdir()
    sources = (packed_rgcn_designs.SOURCE, rgcn_ablate.SOURCE,
               segment_sum_designs.SOURCE, flash_gat_designs.SOURCE)
    probes = [tmp_path / "probes" / p.name for p in sources]
    for src, dst in zip(sources, probes):
        shutil.copy(src, dst)
    monkeypatch.setattr(_build, "SOURCE_DIR", csrc)
    for name in ("sorted_spmm", "packed_rgcn"):
        assert csrc / "segment_sum.cuh" in _build.source_files(name)
    library = (csrc / "sorted_spmm.cu").read_text()
    assert "sorted_segment_sum_kernel" not in library
    assert "segment_sum::dispatch(" in library
    assert "segment_sum::dispatch(" in (csrc / "packed_rgcn.cu").read_text()
    names = list(_build.SIGNATURES)
    before = {name: _build.library_path(name) for name in names}
    probe_before = [_build._library_of(p) for p in probes]
    with open(csrc / "segment_sum.cuh", "a") as f:
        f.write("// edited\n")
    changed = sorted(name for name in names
                     if _build.library_path(name) != before[name])
    assert changed == ["packed_rgcn", "sorted_spmm"]
    after = [_build._library_of(p) for p in probes]
    assert [a != b for a, b in zip(after, probe_before)] == [True, True,
                                                             True, False]
