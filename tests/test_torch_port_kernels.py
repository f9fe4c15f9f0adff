"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX, so they run on a machine with an NVIDIA
GPU and the port alone:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda

Where there is no card they skip (CUDA kernels have no CPU mode); the
CPU-side behaviour of each wrapper is covered in the other
``tests/test_torch_port_*.py`` files. Kernels: ``spmm_csr`` (square and
rectangular CSRs, FAUST's spline operator, examples/faust.py's ``Net``
against the CPU), the
packed-GAT forward and backward, the packed-RGCN forward and backward,
the dense-mask flash-GAT forward and backward, the block-sparse GAT
forward, row pass and column pass, the sorted segment sum, the fused
two-layer GCN forward and backward, the scale operators (``HybridSpmm``,
``BlockSpmm``) and examples/mnist_graclus.py's ``Net`` against the CPU,
and the probes' libraries
(``probes/packed_gat_ablate.cu``, ``probes/packed_rgcn_ablate.cu`` and
the design probes) against the kernels they ablate or precede.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.ops.csr import build_csr
from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

N = 256


@pytest.fixture
def cuda_device():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spmm_csr_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against its plain version, on the card: fp32 and
    bf16 x, narrow and wide F, short rows, empty rows and long rows (one
    of 700 edges, one of 5000), both CSR directions. Two launches give
    bitwise equal results (no atomics)."""
    rng = np.random.default_rng(6)
    s = rng.integers(0, N, 2000).astype(np.int32)
    r = rng.integers(0, N - 40, 2000).astype(np.int32)   # 40 empty rows
    w = rng.normal(size=2000).astype(np.float32)
    r = np.concatenate([r, np.full(700, 3, np.int32),      # long rows
                        np.full(5000, 10, np.int32)])
    s = np.concatenate([s, np.arange(5700, dtype=np.int32) % N])
    w = np.concatenate([w, rng.normal(size=5700).astype(np.float32)])
    for rows, cols in ((r, s), (s, r)):
        csr = build_csr(rows, cols, N).to(cuda_device)
        val = torch.from_numpy(w).to(cuda_device)[csr.perm]
        for f in (1, 7, 16, 33, 128, 300):
            x = torch.randn(N, f, device=cuda_device)
            for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                got = spmm_csr(csr, val, x.to(dt))
                want = spmm_csr_plain(csr, val, x.to(dt))
                torch.cuda.synchronize()
                err = (got - want).abs().max() / want.abs().max()
                assert err <= tol, (f, dt, float(err))
                assert torch.equal(got, spmm_csr(csr, val, x.to(dt)))


@pytest.mark.cuda
def test_spmm_operator_on_card_matches_cpu(cuda_device):
    """``SpmmOperator`` on the card (forward and ``dx`` through the
    kernel, ``dw`` in plain PyTorch) against the same operator on the
    CPU, for ``__call__`` and ``bind``; the kernel's launches counted."""
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    rng = np.random.default_rng(7)
    s = rng.integers(0, N, 3000)
    r = rng.integers(0, N, 3000)
    w = torch.from_numpy(rng.normal(size=3000).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        op = SpmmOperator(s, r, N, device=dev)
        wt = w.to(dev, copy=True).requires_grad_()
        xt = x.to(dev, copy=True).requires_grad_()
        before = spmm_csr.launches
        (op(wt, xt) ** 2).sum().backward()
        xb = x.to(dev, copy=True).requires_grad_()
        (op.bind(w.to(dev))(xb) ** 2).sum().backward()
        grads[str(dev)] = (wt.grad.cpu(), xt.grad.cpu(), xb.grad.cpu(),
                           spmm_csr.launches - before)
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    assert cpu[3] == 0 and card[3] == 4
    for a, b in zip(card[:3], cpu[:3]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _gat_edges(n=512, seed=8):
    """``datasets/graphs.py:gat_hub_edges``: unique (receiver, sender)
    pairs in receiver-major order with one self loop per node, a receiver
    hub (row 3: 500 senders), a sender hub (node 10: 400 receivers), and
    rows with no edges but their loop (nodes n-40 and up)."""
    from pytorch_geometric_tpu_torch.datasets.graphs import gat_hub_edges

    return gat_hub_edges(n, seed)


def _packed_op(edges, n, device):
    """``PackedFlashGat`` over ``edges`` = (senders, receivers)."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    senders, receivers = edges
    return pg.PackedFlashGat(senders=senders, receivers=receivers,
                             num_nodes=n, device=device)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(1, 7), (8, 8), (2, 33), (4, 64), (1, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_packed_gat_kernels_match_plain_on_card(cuda_device, H, C, rate):
    """Forward (raw num‖den) and backward (dd over the receiver-major
    CSR, ds|dh over the sender-major one) against their plain versions,
    fp32 within 1e-5 of the largest reference magnitude, with hub rows on
    both sides. With dropout on, a sender-side kernel that hashed its own
    CSR position instead of the edge id would disagree here. Two
    launches give bitwise equal results (no atomics)."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    n = 512
    op = _packed_op(_gat_edges(n), n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device=cuda_device)
    g = torch.randn(n, H * C + H, generator=gen, device=cuda_device)
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    fwd0, bwd0 = pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches
    got, m = pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate)
    assert torch.equal(m, pg.receiver_max(op.fwd, s))
    want = pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed, rate)
    bwd_args = (op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g, rate)
    got_b = pg.packed_gat_bwd(*bwd_args)
    want_b = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g, rate)
    torch.cuda.synchronize()
    assert (pg.packed_gat_fwd.launches - fwd0,
            pg.packed_gat_bwd.launches - bwd0) == (1, 2)
    assert _rel_err(got, want) <= 1e-5
    for a, b in zip(got_b, want_b):
        assert _rel_err(a, b) <= 1e-5
    for a, b in zip((got, m), pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate)):
        assert torch.equal(a, b)
    for a, b in zip(got_b, pg.packed_gat_bwd(*bwd_args)):
        assert torch.equal(a, b)


def _ppi_like_edges(n=1500, seed=16):
    """examples/ppi.py's edge set on a PPI-like graph: random pairs in
    both directions (some repeated), self loops dropped, one loop a node
    after each receiver's edges (``gat_sparse_edge_set``'s order)."""
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, 14 * n), rng.integers(0, n, 14 * n)
    keep = s != r
    s, r = s[keep], r[keep]
    s, r = (np.concatenate([s, r, np.arange(n)]),
            np.concatenate([r, s, np.arange(n)]))
    order = np.argsort(r, kind="stable")
    return s[order], r[order]


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(4, 256), (6, 121), (8, 135), (8, 102)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_packed_gat_kernels_at_ppi_widths_on_card(cuda_device, H, C, rate):
    """examples/ppi.py's widths, conv1 and conv2's (4, 256) and conv3's
    (6, 121), and the research driver's GAT's (8, 135) and (8, 102), which
    run the wide-head map (a head wider than 32 channels): forward and
    backward against their plain versions within 1e-5 of the largest
    reference magnitude, on an edge set with repeated pairs; against the
    first design (``probes/packed_gat_designs.cu``) num‖den, m and dh
    bitwise, dd and ds within 1e-6; one launch forward, two backward; two
    calls bitwise equal."""
    from probes import packed_gat_designs as pd
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    n = 1500
    senders, receivers = _ppi_like_edges(n)
    assert np.unique(receivers * n + senders).size < senders.size
    op = _packed_op((senders, receivers), n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device=cuda_device)
    g = torch.randn(n, H * C + H, generator=gen, device=cuda_device)
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    fwd0, bwd0 = pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches
    got, m = pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate)
    bwd_args = (op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g, rate)
    got_b = pg.packed_gat_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert (pg.packed_gat_fwd.launches - fwd0,
            pg.packed_gat_bwd.launches - bwd0) == (1, 2)
    assert torch.equal(m, pg.receiver_max(op.fwd, s))
    assert _rel_err(got, pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed,
                                                 rate)) <= 1e-5
    want_b = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g, rate)
    for a, b in zip(got_b, want_b):
        assert _rel_err(a, b) <= 1e-5
    lib = pd.load()
    first = pd.fwd(pd.fwd_entry(lib, "first"), op, (d, s, h, m, seed), rate)
    first_b = pd.bwd(pd.entry(lib, "first"), op, (d, s, h, m, seed, g), rate)
    torch.cuda.synchronize()
    assert torch.equal(first[0], got) and torch.equal(first[1], m)
    assert torch.equal(first_b[2], got_b[2])
    for a, b in zip(got_b[:2], first_b[:2]):
        assert _rel_err(a, b) <= 1e-6
    for a, b in zip((got, m), pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate)):
        assert torch.equal(a, b)
    for a, b in zip(got_b, pg.packed_gat_bwd(*bwd_args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_packed_flash_gat_on_card_matches_cpu(cuda_device):
    """``PackedFlashGat`` on the card (forward and backward through the
    kernels) against the same op on the CPU (plain versions), divided
    output with dropout, gradients of d, s and h, launches counted."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    n, H, C = 512, 4, 8
    edges = _gat_edges(n, seed=9)
    rng = np.random.default_rng(9)
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]
    results = {}
    for dev in ("cpu", cuda_device):
        op = _packed_op(edges, n, dev)
        d, s, h = (a.to(dev, copy=True).requires_grad_()
                   for a in arrays[:3])
        before = (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches)
        out = op(d, s, h, 4321, rate=0.6)
        (out * arrays[3].to(dev)).sum().backward()
        after = (pg.packed_gat_fwd.launches, pg.packed_gat_bwd.launches)
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, d.grad, s.grad, h.grad)],
                             (after[0] - before[0], after[1] - before[1]))
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == (0, 0) and card[1] == (1, 2)
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= 1e-5


#: Widths at which the redesigned bsr row pass and packed-GAT backward
#: are held: each branch of their dispatch (float4 and one-float loads
#: with one and eight heads; an odd width and rows wider than a warp's
#: loads, which take the bsr row pass's first design and the packed GAT's
#: first design at (3, 5) and its wide-head map past 32 channels a head).
REDESIGN_WIDTHS = [(8, 8), (1, 3), (1, 7), (3, 5), (2, 33), (4, 64),
                   (1, 256)]
#: Graphs of those tests (:func:`_redesign_edges`).
REDESIGN_GRAPHS = ["cora", "pubmed_rcm", "hub5003", "blocks16384",
                   "gat_hub"]


@functools.lru_cache(maxsize=None)
def _redesign_edges(name):
    """``(senders, receivers, n, empty)`` of a graph of the redesign
    tests, unique (receiver, sender) pairs in receiver-major order: Cora
    and PubMed after RCM as the GAT trains on them (``gat_edge_set``),
    the masks ``hub5003`` and ``blocks16384`` (``bsr_synthetic_masks``),
    and the hub graph of :func:`_gat_edges`. ``empty``: receivers and
    senders with no edge (``blocks16384``'s rows 100-139 and columns
    300-349), where every output must be 0."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        bsr_synthetic_masks, cora_graph, pubmed_graph)
    from pytorch_geometric_tpu_torch.nn.conv import gat_edge_set

    empty = ([], [])
    if name in ("cora", "pubmed_rcm"):
        graph = (cora_graph("cpu") if name == "cora"
                 else pubmed_graph("cpu")[:2])[1]
        return (*gat_edge_set(graph), graph.num_nodes, empty)
    if name == "gat_hub":
        return (*_gat_edges(), 512, empty)
    for mask, senders, receivers, n, _, _ in bsr_synthetic_masks(0):
        if mask == name:
            key = np.unique(receivers * n + senders)
            if mask == "blocks16384":
                empty = (list(range(100, 140)), list(range(300, 350)))
            return key % n, key // n, n, empty
    raise ValueError(name)


def _redesign_inputs(n, H, C, device, g_width):
    gen = torch.Generator(device=device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=device)
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device=device)
    g = torch.randn(n, g_width, generator=gen, device=device)
    seed = torch.tensor([123457], dtype=torch.int32, device=device)
    return d, s, h, g, seed


@pytest.mark.cuda
@pytest.mark.parametrize("graph", REDESIGN_GRAPHS)
@pytest.mark.parametrize("H,C", REDESIGN_WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_bsr_gat_row_pass_matches_plain_on_card(cuda_device, graph, H, C,
                                                rate):
    """The block-sparse row pass (dd, D) against its plain version, fp32
    within 1e-5 of the largest reference magnitude, at every width its
    dispatch tells apart, on the main path's graphs, hub rows and rows
    without entries (dd and D 0 there); one launch a call, two launches
    bitwise equal, outputs from torch.empty."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    senders, receivers, n, (empty, _) = _redesign_edges(graph)
    mask = bg.BlockMask(receivers, senders, n, device=cuda_device)
    d, s, h, g, seed = _redesign_inputs(n, H, C, cuda_device, H * C)
    out, lse = bg.bsr_gat_fwd_plain(mask, d, s, h, seed, rate)
    args = (d, s, h, lse, out, g, seed, rate)
    want = bg.bsr_gat_bwd_row_plain(mask, *args)
    before = bg.bsr_gat_bwd_row.launches
    got, again = (bg.bsr_gat_bwd_row(mask, *args) for _ in range(2))
    torch.cuda.synchronize()
    assert bg.bsr_gat_bwd_row.launches - before == 2
    for a, b, c in zip(got, want, again):
        assert _rel_err(a, b) <= 1e-5
        assert torch.equal(a, c)
        assert (a[empty] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", REDESIGN_GRAPHS)
@pytest.mark.parametrize("H,C", REDESIGN_WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_packed_gat_backward_matches_plain_on_card(cuda_device, graph, H, C,
                                                   rate):
    """The packed-GAT backward (dd over the receiver-major CSR, ds|dh over
    the sender-major one) against its plain version, fp32 within 1e-5 of
    the largest reference magnitude, at every width its dispatch tells
    apart, on the main path's graphs, hub rows on both sides and rows
    without edges (dd, ds and dh 0 there); two launches a call, two calls
    bitwise equal, outputs from torch.empty."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    senders, receivers, n, (no_in, no_out) = _redesign_edges(graph)
    op = _packed_op((senders, receivers), n, cuda_device)
    d, s, h, g, seed = _redesign_inputs(n, H, C, cuda_device, H * C + H)
    m = pg.receiver_max(op.fwd, s)
    want = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g, rate)
    before = pg.packed_gat_bwd.launches
    got, again = (pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m,
                                    seed, g, rate) for _ in range(2))
    torch.cuda.synchronize()
    assert pg.packed_gat_bwd.launches - before == 4
    for a, b, c in zip(got, want, again):
        assert _rel_err(a, b) <= 1e-5
        assert torch.equal(a, c)
    dd, ds, dh = got
    assert (dd[no_in] == 0).all()
    assert (ds[no_out] == 0).all() and (dh[no_out] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(8, 8), (1, 7), (3, 5), (2, 33), (4, 256),
                                 (6, 121), (8, 135)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_packed_gat_designs_agree_on_card(cuda_device, H, C, rate):
    """``probes/packed_gat_designs.py``: the first design of the backward,
    the library's and the wide-head map's, on the hub graph, each within
    1e-5 of the plain version and within 1e-6 of the first; equal where
    the library runs the first design itself (3, 5); dh bitwise the first
    design's wherever the wide-head map runs (every width in the probe's
    ``wide``, past 32 channels in the library). The library's call is two
    launches, and two calls are bitwise equal."""
    from probes import packed_gat_designs as pd
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    op = _packed_op(_gat_edges(), 512, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    args, errors = pd.compare(pd.load(), op, H, C, rate, gen)
    for design in pd.DESIGNS:
        assert errors[f"{design}_vs_plain"] <= 1e-5, design
    assert errors["first_vs_shipped"] <= (0 if (H, C) == (3, 5) else 1e-6)
    assert errors["first_vs_wide"] <= 1e-6
    assert errors["dh_first_vs_wide"] == 0
    if C > 32:
        assert errors["dh_first_vs_shipped"] == 0
    d, s, h, m, seed, g = args
    bwd_args = (op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g, rate)
    before = pg.packed_gat_bwd.launches
    got, again = (pg.packed_gat_bwd(*bwd_args) for _ in range(2))
    torch.cuda.synchronize()
    assert pg.packed_gat_bwd.launches - before == 4
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(8, 8), (1, 3), (3, 5)])
def test_bsr_gat_designs_agree_on_card(cuda_device, H, C):
    """``probes/bsr_gat_designs.py``: the first design of the three
    block-sparse kernels and the library's, on a hub mask, each within
    1e-5 of the plain versions and within 1e-6 of each other, the row
    pass's D (summed in one order by both) bitwise."""
    from probes import bsr_gat_designs as bd
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    rows, cols = _bsr_entries("hub", 1003)
    mask = bg.BlockMask(rows, cols, 1003, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    _, errors = bd.compare(bd.load(), mask, H, C, 0.6, gen)
    assert {k.split("_vs_")[0] for k in errors} >= {
        "first_bwd_row", "shipped_bwd_row"}
    assert errors["first_vs_shipped_D"] == 0
    for key, err in errors.items():
        assert err <= (1e-6 if "_vs_shipped_" in key else 1e-5), key


def _rgcn_edges(case, n=600, R=7, seed=10):
    """Typed multigraph edges with duplicates and rows without edges
    (nodes n-50 and up neither send nor receive). ``hub``: node 3
    receives 2500 edges and node 10 sends 2200; ``dominant``: relation 2
    holds nine edges in ten."""
    rng = np.random.default_rng(seed)
    e = 5000
    s = rng.integers(0, n - 50, e)
    r = rng.integers(0, n - 50, e)
    et = rng.integers(0, R, e)
    if case == "hub":
        s = np.concatenate([s, rng.integers(0, n - 50, 2500),
                            np.full(2200, 10)])
        r = np.concatenate([r, np.full(2500, 3),
                            rng.integers(0, n - 50, 2200)])
        et = np.concatenate([et, rng.integers(0, R, 4700)])
    elif case == "dominant":
        et = np.where(rng.random(e) < 0.9, 2, et)
    s[:40], r[:40], et[:40] = s[40:80], r[40:80], et[40:80]   # duplicates
    w = rng.random(s.shape[0]).astype(np.float32) + 0.1
    return s, r, et, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "hub", "dominant"])
@pytest.mark.parametrize("B,C", [(30, 16), (30, 2), (5, 33), (8, 20),
                                 (3, 1), (40, 7), (2, 70)])
def test_packed_rgcn_kernels_match_plain_on_card(cuda_device, case, B, C):
    """Forward (each edge's message from the sender-major walk, then the
    receivers' segment sum over the receiver-major CSR) and backward (dxB
    over the sender-major CSR, datt through the relation-major
    reduction) against their plain versions, fp32 within 1e-5 of the
    largest reference magnitude: the main path's (B, C), odd shapes on
    both sides of the 32-lane width (every channel width of the message
    walk; 40 bases at 7 channels, past its registers), a hub row of 2500
    in-edges and one of 2200 out-edges, a relation that holds most
    edges, duplicate edges and empty rows, in embed mode (the source rows
    differ from the nodes). Two launches give bitwise equal results (no
    atomics); outputs come from torch.empty, so an unwritten row would
    show."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    n, R, rows = 600, 7, 640
    s, r, et, w = _rgcn_edges(case, n, R)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB = torch.randn(rows, B * C, generator=gen, device=cuda_device)
    att = torch.randn(R, B, generator=gen, device=cuda_device)
    g = torch.randn(n, C, generator=gen, device=cuda_device)
    fwd0, bwd0 = pr.packed_rgcn_fwd.launches, pr.packed_rgcn_bwd.launches
    fwd_args = (op.fwd, op.send, xB, att)
    bwd_args = (op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos, op.rel_ptr, xB,
                att, g)
    got = pr.packed_rgcn_fwd(*fwd_args)
    want = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    got_b = pr.packed_rgcn_bwd(*bwd_args)
    want_b = pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w, xB, att,
                                      g)
    torch.cuda.synchronize()
    assert (pr.packed_rgcn_fwd.launches - fwd0,
            pr.packed_rgcn_bwd.launches - bwd0) == (2, 3)
    assert _rel_err(got, want) <= 1e-5
    for a, b in zip(got_b, want_b):
        assert _rel_err(a, b) <= 1e-5
    assert torch.equal(got, pr.packed_rgcn_fwd(*fwd_args))
    for a, b in zip(got_b, pr.packed_rgcn_bwd(*bwd_args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,C", [(450, 30, 16), (900, 30, 2)])
def test_packed_rgcn_forward_reads_a_large_att_from_memory_on_card(
        cuda_device, R, B, C):
    """A relation table too large for the message walk's shared memory
    (R B floats over 48 KB) is read from device memory: the same result
    as the plain version within 1e-5, two launches bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    n, rows = 600, 640
    s, r, et, w = _rgcn_edges("hub", n, R)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(R + C)
    xB = torch.randn(rows, B * C, generator=gen, device=cuda_device)
    att = torch.randn(R, B, generator=gen, device=cuda_device)
    assert R * B * 4 > 48 * 1024
    got = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
    want = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(got, pr.packed_rgcn_fwd(op.fwd, op.send, xB, att))


@pytest.mark.cuda
@pytest.mark.parametrize("num_src_rows", [None, 700])
def test_packed_rgcn_spmm_on_card_matches_cpu(cuda_device, num_src_rows):
    """``PackedRgcnSpmm`` on the card (forward and backward through the
    kernels) against the same op on the CPU (plain versions): output and
    the gradients of xB and att, launches counted."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    n, R, B, C = 600, 7, 5, 6
    s, r, et, w = _rgcn_edges("hub", n, R, seed=11)
    rows = n if num_src_rows is None else num_src_rows
    rng = np.random.default_rng(11)
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for shape in ((rows, B * C), (R, B), (n, C))]
    results = {}
    for dev in ("cpu", cuda_device):
        op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=num_src_rows,
                               device=dev)
        xB, att = (a.to(dev, copy=True).requires_grad_()
                   for a in arrays[:2])
        before = (pr.packed_rgcn_fwd.launches, pr.packed_rgcn_bwd.launches)
        out = op(xB, att)
        (out * arrays[2].to(dev)).sum().backward()
        after = (pr.packed_rgcn_fwd.launches, pr.packed_rgcn_bwd.launches)
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, xB.grad, att.grad)],
                             (after[0] - before[0], after[1] - before[1]))
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == (0, 0) and card[1] == (2, 3)
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= 1e-5


def _flash_adj(case, n, seed=12):
    """Directed (asymmetric) boolean masks. ``sparse``: about 4 entries a
    row plus the diagonal; ``half``: every second entry; ``hub``: sparse
    with one full row and one full column. Each has a few rows and
    columns without any entry."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < (0.5 if case == "half" else 4.0 / n)
    if case != "half":
        adj |= np.eye(n, dtype=bool)
    if case == "hub":
        adj[3, :] = True
        adj[:, 10] = True
    adj[[5, n - 1], :] = False          # empty rows
    adj[:, [7, n - 2]] = False          # empty columns
    return torch.from_numpy(adj)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", [("sparse", 300), ("half", 257),
                                    ("hub", 1000)])
@pytest.mark.parametrize("H,C", [(8, 8), (1, 7), (3, 5), (2, 33), (1, 70)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_flash_gat_kernels_match_plain_on_card(cuda_device, case, n, H, C,
                                               rate):
    """Forward (out, lse) and backward (dd over the mask's rows, ds|dh
    over its transpose's) against their plain versions, fp32 within 1e-5
    of the largest reference magnitude: the main path's (H, C), odd
    widths on both sides of the 8- and 32-channel chunks, node
    counts that are no multiple of 32, a sparse, a half-full and a hub
    mask, none symmetric, with empty rows and columns. With dropout on, a
    column pass that hashed (column, row) instead of (row, column) would
    disagree here. Two launches give bitwise equal results (no atomics);
    outputs come from torch.empty, so an unwritten row would show."""
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    adj = _flash_adj(case, n).to(cuda_device)
    assert not torch.equal(adj, adj.t())
    mask = fg.BitMask(adj)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=cuda_device)
            for _ in range(2))
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    fwd0, bwd0 = fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches
    got = fg.flash_gat_fwd(mask, d, s, h, seed, rate)
    want = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    out, lse = want
    got_b = fg.flash_gat_bwd(mask, d, s, h, lse, out, g, seed, rate)
    want_b = fg.flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, rate)
    torch.cuda.synchronize()
    assert (fg.flash_gat_fwd.launches - fwd0,
            fg.flash_gat_bwd.launches - bwd0) == (1, 2)
    for a, b in zip(got + got_b, want + want_b):
        assert _rel_err(a, b) <= 1e-5
    assert (got[0][[5, n - 1]] == 0).all()
    for a, b in zip(got, fg.flash_gat_fwd(mask, d, s, h, seed, rate)):
        assert torch.equal(a, b)
    for a, b in zip(got_b, fg.flash_gat_bwd(mask, d, s, h, lse, out, g,
                                            seed, rate)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_gat_operator_on_card_matches_cpu(cuda_device):
    """``FlashGatOperator`` on the card (forward and backward through the
    kernels) against the same op on the CPU (plain versions): output with
    dropout, gradients of d, s and h, launches counted."""
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    n, H, C = 500, 4, 8
    adj = _flash_adj("hub", n, seed=13)
    rng = np.random.default_rng(13)
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]
    results = {}
    for dev in ("cpu", cuda_device):
        op = fg.FlashGatOperator(adj, device=dev)
        d, s, h = (a.to(dev, copy=True).requires_grad_()
                   for a in arrays[:3])
        before = (fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches)
        out = op(d, s, h, 4321, rate=0.6)
        (out * arrays[3].to(dev)).sum().backward()
        after = (fg.flash_gat_fwd.launches, fg.flash_gat_bwd.launches)
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, d.grad, s.grad, h.grad)],
                             (after[0] - before[0], after[1] - before[1]))
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == (0, 0) and card[1] == (1, 2)
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= 1e-5


def _bsr_entries(case, n, seed=14):
    """(rows, cols) of directed masks as entry lists. ``sparse``: about 4
    entries a row plus the diagonal; ``blocks``: communities of 64 nodes,
    half full, plus sparse entries; ``hub``: sparse with one full row and
    one full column. Each has a few rows and columns without any entry."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.repeat(np.arange(n), 4), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, 4 * n), np.arange(n)])
    if case == "blocks":
        blk, r, c = np.nonzero(rng.random((n // 64, 64, 64)) < 0.5)
        rows = np.concatenate([rows, blk * 64 + r])
        cols = np.concatenate([cols, blk * 64 + c])
    if case == "hub":
        rows = np.concatenate([rows, np.full(n, 3), np.arange(n)])
        cols = np.concatenate([cols, np.arange(n), np.full(n, 10)])
    keep = ~(np.isin(rows, [5, n - 1]) | np.isin(cols, [7, n - 2]))
    return rows[keep], cols[keep]


def _bsr_long_line_entries(n, k, seed=17):
    """``_bsr_entries("sparse", n)`` with row 3 and column 10 holding
    exactly ``k`` entries each, every other row and column far fewer: the
    longest row of the mask and of its transpose is ``k`` long."""
    rows, cols = _bsr_entries("sparse", n, seed)
    rng = np.random.default_rng(seed)
    keep = (rows != 3) & (cols != 10)
    senders = rng.choice(np.setdiff1d(np.arange(n), [7, 10, n - 2]), k,
                         replace=False)
    receivers = rng.choice(np.setdiff1d(np.arange(n), [3, 5, n - 1]), k,
                           replace=False)
    rows = np.concatenate([rows[keep], np.full(k, 3), receivers])
    cols = np.concatenate([cols[keep], senders, np.full(k, 10)])
    return rows, cols


def _check_bsr_kernels(device, rows, cols, n, tile, H, C, rate,
                       empty_rows=(5, -1), empty_cols=(7, -2)):
    """The three block-sparse kernels on one mask against their plain
    versions (1e-5 of the largest reference magnitude) and the dense-mask
    kernels (1e-6), launches counted, zeros in the empty rows and
    columns, two launches bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    mask = bg.BlockMask(rows, cols, n, *tile, device=device)
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    adj[torch.from_numpy(rows), torch.from_numpy(cols)] = True
    assert not torch.equal(adj, adj.t())
    dense = fg.BitMask(adj)
    gen = torch.Generator(device=device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=device)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=device)
            for _ in range(2))
    seed = torch.tensor([123457], dtype=torch.int32, device=device)
    wrappers = (bg.bsr_gat_fwd, bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_col)
    before = [w.launches for w in wrappers]
    want = bg.bsr_gat_fwd_plain(mask, d, s, h, seed, rate)
    out, lse = want
    want_row = bg.bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g, seed,
                                        rate)
    big_d = want_row[1]
    want_col = bg.bsr_gat_bwd_col_plain(mask, d, s, h, lse, big_d, g, seed,
                                        rate)
    calls = ((bg.bsr_gat_fwd, (d, s, h, seed, rate)),
             (bg.bsr_gat_bwd_row, (d, s, h, lse, out, g, seed, rate)),
             (bg.bsr_gat_bwd_col, (d, s, h, lse, big_d, g, seed, rate)))
    got = [fn(mask, *args) for fn, args in calls]
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1]
    for a, b in zip(got[0] + got[1] + got[2], want + want_row + want_col):
        assert _rel_err(a, b) <= 1e-5
    assert (got[0][0][list(empty_rows)] == 0).all()
    assert (got[2][0][list(empty_cols)] == 0).all()
    assert (got[2][1][list(empty_cols)] == 0).all()
    flash = fg.flash_gat_fwd(dense, d, s, h, seed, rate)
    dd, ds, dh = fg.flash_gat_bwd(dense, d, s, h, lse, out, g, seed, rate)
    for a, b in zip(got[0] + (got[1][0],) + got[2], flash + (dd, ds, dh)):
        assert _rel_err(a, b) <= 1e-6
    for first, (fn, args) in zip(got, calls):
        for a, b in zip(first, fn(mask, *args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,tile", [
    ("sparse", 300, (1, 32)), ("sparse", 300, (8, 32)),
    ("blocks", 1000, (1, 32)), ("blocks", 1000, (16, 64)),
    ("hub", 1003, (1, 32)), ("hub", 1003, (5, 96))])
@pytest.mark.parametrize("H,C", [(8, 8), (1, 3), (3, 5), (2, 33), (1, 70)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_bsr_gat_kernels_match_plain_on_card(cuda_device, case, n, tile, H,
                                             C, rate):
    """Forward (out, lse), row pass (dd, D) and column pass (ds, dh)
    against their plain versions, fp32 within 1e-5 of the largest
    reference magnitude, and against the dense-mask kernels on the same
    mask within 1e-6: the main path's (H, C), odd widths on both sides of
    the 8- and 32-channel chunks, node counts that no tile divides, the
    default tile and taller and wider ones, a sparse, a block-dense and a
    hub mask, none symmetric, with empty rows and columns. Two launches
    give bitwise equal results (no atomics); outputs come from
    torch.empty, so an unwritten row would show."""
    rows, cols = _bsr_entries(case, n)
    _check_bsr_kernels(cuda_device, rows, cols, n, tile, H, C, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk", "chunk_plus_one", "ragged_warp"])
@pytest.mark.parametrize("tile", [(1, 32), (4, 64)])
@pytest.mark.parametrize("H,C", [(8, 8), (1, 3), (3, 5), (2, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_bsr_gat_walk_edges_match_plain_on_card(cuda_device, case, tile, H,
                                                C, rate):
    """The edges of the forward's and column pass's walk, with the checks
    of ``test_bsr_gat_kernels_match_plain_on_card``: a mask whose longest
    row and column hold exactly one column-list chunk (the length at (H,
    C) and N that the library exports, ``bsr_gat_chunk``), one whose
    longest hold a chunk and one entry, and 301 rows, so that the last
    warp's sub-warps (rows of 8 lanes at (1, 3) and (2, 2)) run past N."""
    import ctypes

    from pytorch_geometric_tpu_torch.kernels._build import load_library

    n = 301
    chunk_of = load_library("bsr_gat").bsr_gat_chunk
    chunk_of.restype, chunk_of.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    chunk = chunk_of(H, C, n)
    assert chunk >= 4
    if case == "ragged_warp":
        rows, cols = _bsr_entries("sparse", n)
    else:
        k = chunk + (case == "chunk_plus_one")
        rows, cols = _bsr_long_line_entries(n, k)
        key = np.unique(rows * n + cols)
        assert np.bincount(key // n).max() == k
        assert np.bincount(key % n).max() == k
    _check_bsr_kernels(cuda_device, rows, cols, n, tile, H, C, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(1, 32), (8, 64)])
def test_bsr_flash_gat_on_card_matches_cpu(cuda_device, tile):
    """``BsrFlashGat`` on the card (forward and backward through the
    kernels) against the same op on the CPU (plain versions): output with
    dropout, gradients of d, s and h, launches counted."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    n, H, C = 1003, 4, 8
    rows, cols = _bsr_entries("hub", n, seed=15)
    rng = np.random.default_rng(15)
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for shape in ((n, H), (n, H), (n, H * C), (n, H * C))]
    wrappers = (bg.bsr_gat_fwd, bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_col)
    results = {}
    for dev in ("cpu", cuda_device):
        op = bg.BsrFlashGat.from_edges(cols, rows, n, tile_i=tile[0],
                                       tile_j=tile[1], device=dev)
        d, s, h = (a.to(dev, copy=True).requires_grad_()
                   for a in arrays[:3])
        before = [w.launches for w in wrappers]
        out = op(d, s, h, 4321, rate=0.6)
        (out * arrays[3].to(dev)).sum().backward()
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, d.grad, s.grad, h.grad)],
                             [w.launches - b
                              for w, b in zip(wrappers, before)])
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == [0, 0, 0] and card[1] == [1, 1, 1]
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= 1e-5


def _gcn_edges(n=600, seed=16, loops=True):
    """Senders, receivers and weights of a GCN-like edge set: random
    edges, a receiver hub (row 3: 700 edges) and a sender hub (node 10:
    500 edges), rows n-40 and up with nothing but their self loop (with
    ``loops``, a self loop on every node; else those rows are empty)."""
    rng = np.random.default_rng(seed)
    loop = np.arange(n) if loops else np.arange(0)
    s = np.concatenate([rng.integers(0, n, 3000), np.arange(700) % n,
                        np.full(500, 10), loop])
    r = np.concatenate([rng.integers(0, n - 40, 3000), np.full(700, 3),
                        np.arange(500), loop])
    w = rng.random(s.shape[0]).astype(np.float32) + 0.1
    return s, r, w


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 3, 7, 16, 33, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_sorted_segment_sum_kernel_matches_plain_on_card(cuda_device, F,
                                                         dtype, tol):
    """The segment-sum kernel against its plain version, on the card:
    both CSR directions of a graph with empty rows and hub rows, messages
    at a 16-byte-aligned base (vector loads where F allows) and at an
    offset of one element (scalar loads). Two launches bitwise equal."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
        sorted_segment_sum, sorted_segment_sum_plain)

    s, r, _ = _gcn_edges(loops=False)
    n = 600
    for rows, cols in ((r, s), (s, r)):
        csr = build_csr(rows, cols, n).to(cuda_device)
        E = csr.num_edges
        buf = torch.randn(E * F + 1, device=cuda_device).to(dtype)
        for msgs in (buf[:E * F].view(E, F), buf[1:].view(E, F)):
            got = sorted_segment_sum(csr.row_ptr, msgs)
            want = sorted_segment_sum_plain(csr.row_ptr, msgs)
            torch.cuda.synchronize()
            assert _rel_err(got, want) <= tol, (F, dtype)
            if rows is r:        # rows that receive nothing give 0
                assert (got[n - 40:] == 0).all()
            assert torch.equal(got, sorted_segment_sum(csr.row_ptr, msgs))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_sorted_spmm_on_card_matches_cpu(cuda_device, compute_dtype):
    """``SortedSpmm`` (forward and ``dx`` through the kernel, ``dw``
    plain) and ``SortedSegmentSum`` on the card against the same
    operators on the CPU; launches counted."""
    from pytorch_geometric_tpu_torch.ops import sorted_spmm as ss

    s, r, w = _gcn_edges(seed=17)
    n, F = 600, 16
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(n, F)).astype(np.float32))
    msgs = torch.from_numpy(rng.normal(size=(s.shape[0], F))
                            .astype(np.float32))
    tol = 1e-5 if compute_dtype == torch.float32 else 1e-2
    results = {}
    for dev in ("cpu", cuda_device):
        op = ss.SortedSpmm(s, r, n, compute_dtype=compute_dtype, device=dev)
        seg = ss.SortedSegmentSum(r, n, compute_dtype=compute_dtype,
                                  device=dev)
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        xt, mt = (a.to(dev, copy=True).requires_grad_() for a in (x, msgs))
        before = ss.sorted_segment_sum.launches
        out, agg = op(wt, xt), seg(mt)
        ((out ** 2).sum() + (agg ** 3).sum()).backward()
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, agg, wt.grad, xt.grad, mt.grad)],
                             ss.sorted_segment_sum.launches - before)
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == 0 and card[1] == 3
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(16, 3), (16, 7), (1, 1), (5, 16),
                                 (8, 16)])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("loops", [True, False])
def test_fused_gcn_kernels_match_plain_on_card(cuda_device, H, C, rate,
                                               loops):
    """The fused forward and backward kernels against their plain
    versions, on the card, over a graph with hub rows (a receiver of 700
    edges, a sender of 500) and, without self loops, a run of 40 empty
    rows. Two launches bitwise equal."""
    from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

    s, r, w = _gcn_edges(seed=18, loops=loops)
    n = 600
    op = fg.FusedGcn2(s, r, n, w, hidden=H, classes=C, dropout_rate=rate,
                      device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    z1, g2 = (torch.randn(n, k, generator=gen, device=cuda_device)
              for k in (H, C))
    W2 = torch.randn(H, C, generator=gen, device=cuda_device)
    b1 = torch.randn(H, generator=gen, device=cuda_device)
    seed = torch.tensor([987654], dtype=torch.int32, device=cuda_device)
    fwd = (op.op.fwd, op.val_f, z1, W2, b1, seed, rate)
    h1_pre, _ = fg.fused_gcn_fwd_plain(*fwd)
    bwd = (op.op.bwd, op.val_b, g2, W2, b1, h1_pre, seed, rate)
    for kernel, plain, args in ((fg.fused_gcn_fwd, fg.fused_gcn_fwd_plain,
                                 fwd),
                                (fg.fused_gcn_bwd, fg.fused_gcn_bwd_plain,
                                 bwd)):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= 1e-5, (kernel.__name__, H, C, rate)
        for a, b in zip(got, kernel(*args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_fused_gcn2_on_card_matches_cpu(cuda_device, rate):
    """``FusedGcn2`` on the card (both directions through the kernels)
    against the same op on the CPU (plain versions): output and the
    gradients of z1, W2 and b1; launches counted."""
    from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

    s, r, w = _gcn_edges(seed=19)
    n, H, C = 600, 16, 3
    rng = np.random.default_rng(19)
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for shape in ((n, H), (H, C), (H,), (n, C))]
    results = {}
    for dev in ("cpu", cuda_device):
        op = fg.FusedGcn2(s, r, n, w, hidden=H, classes=C,
                          dropout_rate=rate, device=dev)
        z1, W2, b1 = (a.to(dev, copy=True).requires_grad_()
                      for a in arrays[:3])
        before = (fg.fused_gcn_fwd.launches, fg.fused_gcn_bwd.launches)
        out = op(z1, W2, b1, 24680)
        (out * arrays[3].to(dev)).sum().backward()
        results[str(dev)] = ([t.detach().cpu() for t in
                              (out, z1.grad, W2.grad, b1.grad)],
                             (fg.fused_gcn_fwd.launches - before[0],
                              fg.fused_gcn_bwd.launches - before[1]))
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert cpu[1] == (0, 0) and card[1] == (2, 2)
    for a, b in zip(card[0], cpu[0]):
        assert _rel_err(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(8, 8), (1, 7)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_gat_ablate_full_is_the_library_and_every_mode_runs(cuda_device, H,
                                                            C, rate):
    """The ablation probe's ``full`` mode gives the library's
    ``packed_gat_bwd`` bit for bit; every other mode launches once per
    walk and gives finite outputs, with hub rows on both sides."""
    from probes import gat_ablate as ga
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    n = 512
    op = _packed_op(_gat_edges(n), n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device=cuda_device)
    g = torch.randn(n, H * C + H, generator=gen, device=cuda_device)
    m = pg.receiver_max(op.fwd, s)
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    lib = ga.load()
    before = ga.ablate_walk.launches
    outs = {mode: ga.ablate_bwd(lib, op, d, s, h, m, seed, g, rate, mode)
            for mode in ga.MODES}
    want = pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g,
                             rate)
    torch.cuda.synchronize()
    assert ga.ablate_walk.launches - before == 2 * len(ga.MODES)
    for a, b in zip(outs["full"], want):
        assert torch.equal(a, b)
    for mode, out in outs.items():
        assert all(bool(torch.isfinite(t).all()) for t in out), mode


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "hub"])
@pytest.mark.parametrize("B,C", [(30, 16), (30, 2)])
def test_rgcn_ablate_full_is_the_library_and_every_mode_runs(cuda_device,
                                                             case, B, C):
    """The ablation probe's ``full`` mode gives the library's
    ``packed_rgcn_bwd`` bit for bit; every other mode launches (the walk,
    and the reduction unless ``nodatt``) and gives finite outputs."""
    from probes import rgcn_ablate as ra
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    n, R, rows = 600, 7, 640
    s, r, et, w = _rgcn_edges(case, n, R)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB = torch.randn(rows, B * C, generator=gen, device=cuda_device)
    att = torch.randn(R, B, generator=gen, device=cuda_device)
    g = torch.randn(n, C, generator=gen, device=cuda_device)
    lib = ra.load()
    before = ra.ablate_bwd.launches
    outs = {mode: ra.ablate_bwd(lib, op, xB, att, g, mode)
            for mode in ra.MODES}
    want = pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                              op.rel_ptr, xB, att, g)
    torch.cuda.synchronize()
    assert ra.ablate_bwd.launches - before == 3 * len(ra.MODES) - 2
    for a, b in zip(outs["full"], want):
        assert torch.equal(a, b)
    for mode, out in outs.items():
        assert all(bool(torch.isfinite(t).all()) for t in out), mode


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "hub", "dominant"])
@pytest.mark.parametrize("B,C", [(30, 16), (30, 2), (5, 33), (8, 20)])
def test_rgcn_prefetch_depths_equal_depth_one_on_card(cuda_device, case, B,
                                                      C):
    """The shipped forward's message walk at prefetch depths 2 and 4 gives
    depth 1's bits; depth 1 is the library's ``packed_rgcn_fwd`` (bit for
    bit), within 1e-5 of the plain version: hub rows, empty rows,
    duplicate edges, embed mode, a second pass of channels past 32."""
    from probes import rgcn_ablate as ra
    from probes import rgcn_pipe_probe as rp
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    n, R, rows = 600, 7, 640
    s, r, et, w = _rgcn_edges(case, n, R)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=rows,
                           device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB = torch.randn(rows, B * C, generator=gen, device=cuda_device)
    att = torch.randn(R, B, generator=gen, device=cuda_device)
    lib = ra.load()
    got = {depth: rp.pipe_fwd(lib, op, xB, att, depth)
           for depth in rp.DEPTHS}
    library = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
    plain = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    torch.cuda.synchronize()
    assert torch.equal(got[1], library)
    assert _rel_err(got[1], plain) <= 1e-5
    for depth in rp.DEPTHS[1:]:
        assert torch.equal(got[depth], got[1]), depth


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["gat", "rgcn_conv1", "rgcn_conv2"])
def test_occupancy_padding_holds_modes_at_full_and_changes_no_output(
        cuda_device, probe):
    """With the padding that ``occupancy_padding`` finds, no mode's walk
    fits more blocks per SM than ``full`` does unpadded, ``full`` keeps
    its count, and the padded launch gives the unpadded one's bits."""
    from probes import gat_ablate as ga
    from probes import rgcn_ablate as ra
    from probes.common import occupancy_padding
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    if probe == "gat":
        n, H, C = 512, 8, 8
        op = _packed_op(_gat_edges(n), n, cuda_device)
        d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
                for _ in range(2))
        h = torch.randn(n, H * C, generator=gen, device=cuda_device)
        g = torch.randn(n, H * C + H, generator=gen, device=cuda_device)
        seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
        lib = ga.load()
        for walk in (0, 1):
            def blocks(mode, smem):
                return ga.blocks_per_sm(lib, mode, walk, n, H, C, smem)
            smem, target = occupancy_padding(blocks, list(ga.MODES))
            assert blocks("full", smem) == target
            assert all(blocks(md, smem) <= target for md in ga.MODES)
            m = pg.receiver_max(op.fwd, s)
            plain, padded = (ga.ablate_walk(lib, op, d, s, h, m, seed, g,
                                            0.6, "full", walk, smem=pad)
                             for pad in (0, smem))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(plain, padded))
        return
    B, C = (30, 16) if probe == "rgcn_conv1" else (30, 2)
    n, R = 600, 7
    s_, r_, et, w = _rgcn_edges("uniform", n, R)
    op = pr.PackedRgcnSpmm(s_, r_, et, R, n, w, device=cuda_device)
    xB = torch.randn(n, B * C, generator=gen, device=cuda_device)
    att = torch.randn(R, B, generator=gen, device=cuda_device)
    g = torch.randn(n, C, generator=gen, device=cuda_device)
    lib = ra.load()

    def blocks(mode, smem):
        return ra.blocks_per_sm(lib, mode, C, smem)
    smem, target = occupancy_padding(blocks, list(ra.MODES))
    assert blocks("full", smem) == target
    assert all(blocks(md, smem) <= target for md in ra.MODES)
    plain = ra.ablate_bwd(lib, op, xB, att, g)
    padded = ra.ablate_bwd(lib, op, xB, att, g, "full", smem=smem)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, padded))


@pytest.mark.cuda
def test_build_source_rebuilds_when_an_included_source_changes(
        cuda_device, tmp_path, monkeypatch):
    """A probe library is rebuilt, under a new name, when the production
    source it includes changes, and the new library loads and runs."""
    from probes import rgcn_ablate as ra
    from probes import rgcn_pipe_probe as rp
    from pytorch_geometric_tpu_torch.kernels import _build
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    (tmp_path / "probes").mkdir()
    csrc = tmp_path / "pytorch_geometric_tpu_torch" / "csrc"
    shutil.copytree(_build.SOURCE_DIR, csrc)
    probe = tmp_path / "probes" / ra.SOURCE.name
    shutil.copy(ra.SOURCE, probe)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    first = _build.build_source(probe, ra.SIGNATURES)
    before = _build._library_of(probe)
    with open(csrc / "packed_rgcn.cu", "a") as f:
        f.write("// edited\n")
    after = _build._library_of(probe)
    second = _build.build_source(probe, ra.SIGNATURES)
    assert before != after and before.exists() and after.exists()
    assert second is not first
    n, R, B, C = 600, 7, 30, 16
    s, r, et, w = _rgcn_edges("uniform", n, R)
    op = pr.PackedRgcnSpmm(s, r, et, R, n, w, device=cuda_device)
    xB = torch.randn(n, B * C, device=cuda_device)
    att = torch.randn(R, B, device=cuda_device)
    library = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
    for lib in (first, second):
        out = rp.pipe_fwd(lib, op, xB, att, 2)
        torch.cuda.synchronize()
        assert torch.equal(out, rp.pipe_fwd(lib, op, xB, att, 1))
        assert _rel_err(out, library) <= 1e-5


@functools.lru_cache(maxsize=None)
def _redesign_flash_adj(name):
    """The dense masks of ``probes/flash_gat_designs.py``, on the card:
    Cora's GAT mask, and the half-full and cap masks of
    ``datasets/graphs.py:flash_synthetic_masks``."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, flash_synthetic_masks)
    from pytorch_geometric_tpu_torch.nn.conv import gat_dense_adj

    if name == "cora":
        return gat_dense_adj(cora_graph("cuda")[1])
    return torch.from_numpy(dict(flash_synthetic_masks(0))[name]).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("graph,H,C", [("cora", 8, 8), ("cora", 1, 7),
                                       ("half2048", 8, 8),
                                       ("cap8192", 8, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_flash_gat_backward_designs_match_plain_on_card(cuda_device, graph,
                                                        H, C, rate):
    """The dense-mask backward at the design probe's widths: the library
    (a warp per mask row), the first design, and the probe's variants
    (fewer lanes a row at one head; the column pass with the channel
    map), each within 1e-5 of the plain version; the first design within
    1e-6 of the library (4e-6 on the half-full mask, whose rows sum about
    1,000 terms each in another order: both designs lie 1-2e-6 from the
    plain version there), D bitwise equal; two launches of the library
    bitwise equal, two launches counted."""
    from probes import flash_gat_designs as fd
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    adj = _redesign_flash_adj(graph)
    mask = fg.BitMask(adj)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    inputs, errors = fd.compare(fd.load(), adj, mask, H, C, rate, gen)
    assert set(errors) >= {f"{d}_vs_plain" for d in fd.designs(H, C)}
    designs_tol = 4e-6 if graph == "half2048" else 1e-6
    for key, err in errors.items():
        assert err <= (designs_tol if key == "first_vs_shipped"
                       else 1e-5), key
    assert errors["first_vs_shipped_D"] == 0
    d, s, h, lse, out, g, seed = inputs
    before = fg.flash_gat_bwd.launches
    got = fg.flash_gat_bwd(mask, d, s, h, lse, out, g, seed, rate)
    again = fg.flash_gat_bwd(mask, d, s, h, lse, out, g, seed, rate)
    torch.cuda.synchronize()
    assert fg.flash_gat_bwd.launches - before == 4
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("graph,H,C", [("cora", 8, 8), ("cora", 1, 7),
                                       ("half2048", 8, 8),
                                       ("cap8192", 8, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_flash_gat_forward_designs_match_plain_on_card(cuda_device, graph,
                                                       H, C, rate):
    """The dense-mask forward at the design probe's masks and the main
    path's widths: the library (a warp per mask row, the softmax chunk by
    chunk) and the first design (a group of 8 lanes per (row, head)),
    out and lse each within 1e-5 of the plain version and within 1e-6 of
    each other (4e-6 on the half-full mask, whose rows sum about 1,000
    terms each in another order, as the backward's designs do); two
    launches of the library bitwise equal, one launch counted a call."""
    from probes import flash_gat_designs as fd
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    adj = _redesign_flash_adj(graph)
    mask = fg.BitMask(adj)
    n = mask.n
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device=cuda_device)
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    inputs = (d, s, h, None, None, None, seed)
    errors, repeat = fd.compare_fwd(fd.load(), adj, mask, inputs, rate)
    assert repeat
    designs_tol = 4e-6 if graph == "half2048" else 1e-6
    for key, err in errors.items():
        assert err <= (designs_tol if key == "fwd_first_vs_shipped"
                       else 1e-5), key
    before = fg.flash_gat_fwd.launches
    got = fg.flash_gat_fwd(mask, d, s, h, seed, rate)
    torch.cuda.synchronize()
    assert fg.flash_gat_fwd.launches - before == 1
    shipped = fd.fwd(fd.load(), "shipped", mask, inputs, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, shipped))


@pytest.mark.cuda
@pytest.mark.parametrize("H,C", [(8, 8), (1, 7)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_bsr_gat_agrees_with_flash_gat_at_cora_on_card(cuda_device, H, C,
                                                       rate):
    """The block-sparse kernels against the dense-mask kernels on Cora's
    mask, the main path's graph: every output within 1e-6 of the largest
    magnitude (their dd and dz sum in other orders; D, summed in one
    order by both, bitwise)."""
    from pytorch_geometric_tpu_torch.datasets.graphs import cora_graph
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    adj = _redesign_flash_adj("cora")
    dense = fg.BitMask(adj)
    mask = gat_flash_op(cora_graph("cuda")[1], "bsr").mask
    n = mask.n
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=cuda_device)
            for _ in range(2))
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    out, lse = fg.flash_gat_fwd(dense, d, s, h, seed, rate)
    flash = fg.flash_gat_bwd(dense, d, s, h, lse, out, g, seed, rate)
    dd, big_d = bg.bsr_gat_bwd_row(mask, d, s, h, lse, out, g, seed, rate)
    ds, dh = bg.bsr_gat_bwd_col(mask, d, s, h, lse, big_d, g, seed, rate)
    bsr_out = bg.bsr_gat_fwd(mask, d, s, h, seed, rate)
    torch.cuda.synchronize()
    for a, b in zip(bsr_out + (dd, ds, dh), (out, lse) + flash):
        assert _rel_err(a, b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["conv1", "conv2", "hub"])
def test_packed_rgcn_backward_designs_agree_on_card(cuda_device, case):
    """``probes/packed_rgcn_designs.py`` on its cases (MUTAG conv1 (30,
    16) and conv2 (30, 2), the hub operator (5, 33)): the first design,
    the library and the probe's variants of its walk each within 1e-5 of
    the plain version and bitwise equal to the library (every walk sums
    in one order); two launches of the library bitwise equal, three
    launches counted."""
    from probes import packed_rgcn_designs as rd
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    op = rd.ops()[case]
    _, B, C = next(c for c in rd.CASES if c[0] == case)
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB, att, g = rd.inputs(op, B, C, gen)
    designs = rd.all_designs()
    agree = rd.compare(rd.load(), op, xB, att, g, designs)
    assert set(agree) == set(designs)
    for design, (err, bitwise) in agree.items():
        assert err <= 1e-5 and bitwise, design
    args = (op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos, op.rel_ptr, xB, att, g)
    before = pr.packed_rgcn_bwd.launches
    got, again = pr.packed_rgcn_bwd(*args), pr.packed_rgcn_bwd(*args)
    torch.cuda.synchronize()
    assert pr.packed_rgcn_bwd.launches - before == 6
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["conv1", "conv2", "hub"])
def test_packed_rgcn_forward_designs_agree_on_card(cuda_device, case):
    """``probes/packed_rgcn_designs.py``'s forwards on its cases (MUTAG
    conv1 (30, 16) and conv2 (30, 2), the hub operator (5, 33) with its
    receiver row of 3,013 edges): the first design (a warp per receiver
    row) and the library (the sender-major messages, then the segment
    sum) each within 1e-5 of the plain version and of each other (they
    sum in other orders); two launches of the library bitwise equal, two
    launches counted a call, and the library's C entry point called by
    the probe gives the wrapper's bits."""
    from probes import packed_rgcn_designs as rd
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    op = rd.ops()[case]
    _, B, C = next(c for c in rd.CASES if c[0] == case)
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB, att, _ = rd.inputs(op, B, C, gen)
    lib = rd.load()
    errors, repeat = rd.compare_fwd(lib, op, xB, att)
    assert repeat
    for key, err in errors.items():
        assert err <= 1e-5, key
    before = pr.packed_rgcn_fwd.launches
    got = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
    torch.cuda.synchronize()
    assert pr.packed_rgcn_fwd.launches - before == 2
    assert torch.equal(got, rd.fwd(lib, "shipped", op, xB, att))
    if case == "hub":
        lengths = op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]
        assert int(lengths.max()) == 3013


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(5, 33), (30, 16), (30, 2)])
def test_packed_rgcn_backward_walks_the_hub_row_on_card(cuda_device, B, C):
    """The hub operator's sender row of 2,511 out-edges (80 passes of 32
    edge indices) at the probe's width and the main path's: the library
    against the plain version, its dxB row and the dae of its edges
    (through datt) within 1e-5."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        rgcn_hub_operator)
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    op = rgcn_hub_operator(cuda_device, 0)
    lengths = op.bwd.row_ptr[1:] - op.bwd.row_ptr[:-1]
    assert int(lengths[10]) == 2511 == int(lengths.max())
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + C)
    xB = torch.randn(op.num_src_rows, B * C, generator=gen,
                     device=cuda_device)
    att = torch.randn(op.R, B, generator=gen, device=cuda_device)
    g = torch.randn(op.num_nodes, C, generator=gen, device=cuda_device)
    got = pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                             op.rel_ptr, xB, att, g)
    want = pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w, xB, att, g)
    torch.cuda.synchronize()
    assert _rel_err(got[0][10], want[0][10]) <= 1e-5
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-5


@functools.lru_cache(maxsize=None)
def _step_edges(n=301, seed=4):
    """``(senders, receivers, empty rows)`` over ``n`` nodes, unique
    (receiver, sender) pairs in receiver-major order, whose rows hold
    every length from 0 to 40 edges (rows 0-40: a row of exactly one step
    of each lane map, R NB edges of 4, 8, 16 or 32, and one of a step
    plus one), a hub row of 280 (row 100), 33 at the last row (the last
    warp's other sub-warps lie past ``n``), 0 to 6 elsewhere, and empty
    rows (row 0 and some of the short ones)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 7, n)
    lengths[:41] = np.arange(41)
    lengths[100], lengths[n - 1] = 280, 33
    receivers = np.repeat(np.arange(n), lengths)
    senders = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lengths])
    return senders, receivers, np.flatnonzero(lengths == 0)


def _offset(t, offset):
    """``t`` itself, or a copy of it one element into a larger buffer (so
    that its rows lose their 16-byte alignment)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("F", [1, 3, 4, 7, 16, 32, 64, 128, 33, 300])
def test_spmm_csr_designs_agree_on_card(cuda_device, F, dtype, tol, offset):
    """``probes/spmm_csr_designs.py`` at every width class of the
    dispatcher (the row map at P = 4, 8, 16 and 32 lanes across the
    channels, a float4 a lane or, with x one element off its alignment,
    one channel a lane, at 16 and at 32 lanes a row; the chunk map at 33
    and 300; the first design for bf16 of 65 to 128 channels), both CSR
    directions of a graph with rows of exactly one step and one step plus
    one of every lane map, a hub row of 280 edges, empty rows and 301
    rows: the first design, the library, the row map at 16 and 32 lanes
    and the chunk map at each K each within ``tol`` of the plain version,
    the first within 1e-6 of the library, the chunk map bitwise equal to
    the first, two launches bitwise equal, empty rows 0, one launch
    counted a call."""
    from probes import spmm_csr_designs as sd

    senders, receivers, empty = _step_edges()
    n = 301
    w = torch.from_numpy(np.random.default_rng(F).normal(
        size=senders.shape).astype(np.float32)).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(F)
    lib = sd.load()
    for rows, cols in ((receivers, senders), (senders, receivers)):
        csr = build_csr(rows, cols, n).to(cuda_device)
        val = w[csr.perm].contiguous()
        x = _offset(torch.randn(n, F, generator=gen,
                                device=cuda_device).to(dtype), offset)
        errors, same, repeat = sd.compare(lib, csr, val, x)
        assert repeat
        assert ("lanes16_vs_plain" in errors) == (F <= 32 or (
            F % 4 == 0 and F <= 128 and not offset))
        for key, err in errors.items():
            assert err <= (1e-6 if key == "first_vs_shipped" else tol), key
        assert all(ok for design, ok in same.items()
                   if design.startswith("chunks")), same
        before = spmm_csr.launches
        got = spmm_csr(csr, val, x)
        torch.cuda.synchronize()
        assert spmm_csr.launches - before == 1
        assert torch.equal(got, sd.spmm(lib, "shipped", csr, val, x))
        if rows is receivers:
            assert (got[torch.from_numpy(empty)] == 0).all()
        if F == 16 and rows is receivers:
            lengths = csr.row_ptr[1:] - csr.row_ptr[:-1]
            assert int(lengths.max()) == 280


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("F", [33, 300, 1024, 1433])
def test_spmm_csr_chunk_map_is_the_first_design_on_card(cuda_device, F,
                                                        dtype, tol, offset):
    """The chunk map of ``spmm_csr`` (a warp per row and chunk of
    channels) at every K and the library, past the row map's 32 slots
    (33 and 1433 at one channel a load, 300 and 1024 at four, or one
    with x one element off its alignment; bf16 x too), both
    CSR directions of a graph with a receiver row of 700 edges, a sender
    of 500 and 40 empty rows: every design bitwise equal to the first
    (each element summed over its row in CSR order), within ``tol`` of
    the plain version, two launches bitwise equal, empty rows 0, one
    launch counted a call."""
    from probes import spmm_csr_designs as sd

    s, r, w = _gcn_edges(loops=False)
    n = 600
    lib = sd.load()
    gen = torch.Generator(device=cuda_device).manual_seed(F)
    for rows, cols in ((r, s), (s, r)):
        csr = build_csr(rows, cols, n).to(cuda_device)
        val = torch.from_numpy(w).to(cuda_device)[csr.perm].contiguous()
        x = _offset(torch.randn(n, F, generator=gen,
                                device=cuda_device).to(dtype), offset)
        errors, same, repeat = sd.compare(lib, csr, val, x)
        assert repeat and same and all(same.values()), same
        assert {f"chunks{k}" for k in sd.CHUNK_K
                if sd.vec_of(F, x) * k <= 16} <= set(same)
        assert all(err <= tol for key, err in errors.items()
                   if key != "first_vs_shipped"), errors
        assert errors["first_vs_shipped"] == 0
        before = spmm_csr.launches
        got = spmm_csr(csr, val, x)
        torch.cuda.synchronize()
        assert spmm_csr.launches - before == 1
        assert torch.equal(got, sd.spmm(lib, "first", csr, val, x))
        if rows is r:
            assert (got[n - 40:] == 0).all()
            assert int((csr.row_ptr[1:] - csr.row_ptr[:-1]).max()) >= 700


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("F", [129, 257, 1024, 1433])
def test_sorted_segment_sum_chunk_map_is_the_first_design_on_card(
        cuda_device, F, dtype, tol, offset):
    """The segment sum's chunk map (a warp per row and chunk of channels)
    at every K and the library, past the first design's 32 chunks a row
    (129, 257 and 1433 at one element a load; 1024 at 16 bytes a load,
    or one element with the messages one element off their alignment),
    both CSR directions of a graph with a receiver row of 700 messages, a
    sender of 500 and 40 empty rows: every design bitwise equal to the
    first (each element summed over its row in CSR order, in one
    accumulator), within ``tol`` of the plain version, two launches
    bitwise equal, empty rows 0, one launch counted a call."""
    from probes import segment_sum_designs as gd
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
        sorted_segment_sum)

    s, r, _ = _gcn_edges(loops=False)
    n = 600
    lib = gd.load()
    gen = torch.Generator(device=cuda_device).manual_seed(F)
    for rows, cols in ((r, s), (s, r)):
        csr = build_csr(rows, cols, n).to(cuda_device)
        msgs = _offset(torch.randn(csr.num_edges, F, generator=gen,
                                   device=cuda_device).to(dtype), offset)
        errors, same, repeat = gd.compare(lib, csr.row_ptr, msgs)
        assert repeat and all(same.values()), same
        assert set(same) == set(gd.designs(F, msgs)) - {"first"}
        assert all(err <= tol for err in errors.values()), errors
        before = sorted_segment_sum.launches
        got = sorted_segment_sum(csr.row_ptr, msgs)
        torch.cuda.synchronize()
        assert sorted_segment_sum.launches - before == 1
        assert torch.equal(got, gd.segment_sum(lib, "first", csr.row_ptr,
                                               msgs))
        if rows is r:
            assert (got[n - 40:] == 0).all()
            assert int((csr.row_ptr[1:] - csr.row_ptr[:-1]).max()) >= 700


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("H,C", [(8, 8), (4, 16), (4, 4), (16, 2), (1, 7),
                                 (2, 6), (1, 32), (3, 5), (6, 4), (12, 4),
                                 (2, 33), (4, 64), (4, 256), (6, 121),
                                 (8, 135), (1, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_packed_gat_forward_designs_agree_on_card(cuda_device, H, C, rate,
                                                  offset):
    """``probes/packed_gat_designs.py``'s forwards at every width class of
    the dispatcher (the row map with float4 heads of 8 and 32 registers,
    (8, 8), (4, 16) and (4, 4), and with one channel a lane, (16, 2),
    (1, 7), (2, 6) and (1, 32), and with h one float off its alignment;
    with heads that do not divide the lanes, idle lanes past the last
    entry group, (3, 5), (6, 4) and, with float4 heads, (12, 4); the
    wide-head map past 32 channels a head, (2, 33), (4, 64), PPI's
    (4, 256) and (6, 121), the research driver's (8, 135) and (1, 256),
    with float4 loads where aligned), on a graph with rows of exactly one
    step and one step plus one of every lane map, rows of 0-40 edges, a
    hub row of 280 edges, empty rows and 301 rows: every design within
    1e-5 of the plain version, the library within 1e-6 of the first design
    and bitwise equal to it past 32 channels a head, the wide-head map
    bitwise equal to it at every width (num‖den and m), two launches of
    the library bitwise equal, one launch counted a call, empty rows 0."""
    from probes import packed_gat_designs as pd
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    senders, receivers, empty = _step_edges()
    n = 301
    op = _packed_op((senders, receivers), n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(H * 1000 + C)
    d, s = (torch.randn(n, H, generator=gen, device=cuda_device)
            for _ in range(2))
    h = _offset(torch.randn(n, H * C, generator=gen, device=cuda_device),
                offset)
    seed = torch.tensor([123457], dtype=torch.int32, device=cuda_device)
    inputs = (d, s, h, pg.receiver_max(op.fwd, s), seed)
    lib = pd.load()
    errors, repeat = pd.compare_fwd(lib, op, inputs, rate)
    assert repeat
    wide_map = C > 32
    for key, err in errors.items():
        if key == "fwd_first_vs_wide":
            assert err == 0, key
        elif key == "fwd_first_vs_shipped":
            assert err <= (0.0 if wide_map else 1e-6), key
        else:
            assert err <= 1e-5, key
    before = pg.packed_gat_fwd.launches
    got = pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate, op.slope)
    torch.cuda.synchronize()
    assert pg.packed_gat_fwd.launches - before == 1
    for a, b in zip(got, pd.fwd(pd.fwd_entry(lib, "shipped"), op, inputs,
                                rate)):
        assert torch.equal(a, b)
    for a in got:
        assert (a[torch.from_numpy(empty)] == 0).all()


# ---------------------------------------------------------------------------
# The message-passing core and the citation suite's shapes
# ---------------------------------------------------------------------------

def _cora_cuda():
    """Cora's graph, and Spline's (with ``TargetIndegree``), on the card."""
    from pytorch_geometric_tpu_torch.examples.citation_suite import load

    return load("sgc")[1], load("spline")[1]


def _vs_plain(csr, val, x, tol):
    got, again = spmm_csr(csr, val, x), spmm_csr(csr, val, x)
    want = spmm_csr_plain(csr, val, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol and torch.equal(got, again), err


@pytest.mark.cuda
def test_spmm_csr_at_the_suites_widths_on_card(cuda_device):
    """``spmm_csr`` at F = 1433 (SGC's propagation of Cora's features,
    Spline's conv1) on the Cora GCN CSR and on each of Spline's
    per-kernel-index CSRs, both directions, and at ARMA's 48 and AGNN's
    16; fp32 1e-5 against the plain version, two launches bitwise
    equal."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
    from pytorch_geometric_tpu_torch.nn.conv import spline_operators

    graph, spline = _cora_cuda()
    op, w = gcn_spmm_operator(graph)
    val_f, val_b = op.route_weights(w)
    for csr, val in ((op.fwd, val_f), (op.bwd, val_b)):
        for f in (1433, 48, 16):
            x = torch.randn(csr.num_cols, f, device=cuda_device)
            _vs_plain(csr, val, x, 1e-5)
    fns = spline_operators(spline, dim=1, kernel_size=2)
    x = torch.randn(spline.num_nodes, 1433, device=cuda_device)
    xc = x.cpu()
    for fn, cpu_fn in zip(fns, spline_operators(spline.to("cpu"), dim=1,
                                                kernel_size=2)):
        got = fn(x)
        torch.cuda.synchronize()
        want = cpu_fn(xc)
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-5, err


@pytest.mark.cuda
def test_sorted_segment_sum_at_dnas_shape_on_card(cuda_device):
    """The segment sum at DNA's shape: ``dna_operators``' messages on Cora
    (its GCN edge set), F = 128, fp32 1e-5, two launches bitwise equal;
    and ``DNAConv`` on the card against the CPU."""
    from pytorch_geometric_tpu_torch.nn.conv import DNAConv, dna_operators
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
        sorted_segment_sum, sorted_segment_sum_plain)

    graph, _ = _cora_cuda()
    ops = dna_operators(graph)
    rp = ops["segment_op"].csr.row_ptr
    msgs = torch.randn(ops["norm"].receivers.shape[0], 128,
                       device=cuda_device)
    got, again = sorted_segment_sum(rp, msgs), sorted_segment_sum(rp, msgs)
    want = sorted_segment_sum_plain(rp, msgs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5 and torch.equal(got, again), err
    conv = DNAConv(128, heads=8, groups=16,
                   generator=torch.Generator().manual_seed(0))
    x_all = torch.randn(graph.num_nodes, 2, 128)
    cpu = graph.to("cpu")
    with torch.no_grad():
        want = conv(cpu, x_all, **dna_operators(cpu))
        got = conv.to(cuda_device)(graph, x_all.to(cuda_device), **ops)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_propagate_on_card_needs_its_operator(cuda_device):
    """On a CUDA tensor ``propagate`` sums through the kernels and raises
    without an operator, rather than scatter; ``max`` runs (torch's
    ``scatter_reduce``)."""
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.nn.message_passing import (
        propagate, propagate_operators)

    graph, _ = _cora_cuda()
    x = torch.randn(graph.num_nodes, 16, device=cuda_device)
    for aggr in ("add", "sum", "mean"):
        with pytest.raises(ValueError, match="needs"):
            propagate(graph, x, aggr=aggr)
        with pytest.raises(ValueError, match="needs"):
            propagate(graph, x, lambda xj, xi, ea: xj * xi, aggr=aggr)
    ops = propagate_operators(graph)
    before = launch_counts()
    out = propagate(graph, x, aggr="add", **ops)
    msg = propagate(graph, x, lambda xj, xi, ea: xj * xi, aggr="mean", **ops)
    propagate(graph, x, aggr="max")
    after = launch_counts()
    assert after["spmm_csr"] - before["spmm_csr"] == 1
    assert after["sorted_segment_sum"] - before["sorted_segment_sum"] == 1
    cpu = graph.to("cpu")
    cops = propagate_operators(cpu)
    for got, want in ((out, propagate(cpu, x.cpu(), aggr="add", **cops)),
                      (msg, propagate(cpu, x.cpu(), lambda xj, xi, ea: xj
                                      * xi, aggr="mean", **cops))):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-5, err


@pytest.mark.cuda
def test_spmm_csr_on_rectangular_operators_on_card(cuda_device):
    """``spmm_csr`` on CSRs whose rows and columns differ, both ways
    round, and on a FAUST mesh's spline operator (N·125 rows over N
    columns: most rows empty, the rest 1-3 entries; its transpose ~47 a
    row), forward and transposed, at F = 1, 32 and 64 (examples/faust.py's
    widths), fp32 1e-5 and bf16 x 1e-2 against the plain version, two
    launches bitwise equal."""
    from pytorch_geometric_tpu_torch.examples import faust

    rng = np.random.default_rng(9)
    for n_src, n_dst in ((N, 3 * N), (3 * N, N)):
        s = rng.integers(0, n_src, 4000)
        r = rng.integers(0, n_dst - 30, 4000)
        w = torch.from_numpy(rng.normal(size=4000).astype(np.float32))
        for rows, cols, nr, nc in ((r, s, n_dst, n_src),
                                   (s, r, n_src, n_dst)):
            csr = build_csr(rows, cols, nr, nc).to(cuda_device)
            val = w.to(cuda_device)[csr.perm]
            for f in (1, 32, 64, 300):
                x = torch.randn(nc, f, device=cuda_device)
                _vs_plain(csr, val, x, 1e-5)
                _vs_plain(csr, val, x.bfloat16(), 1e-2)
    train, _ = faust.load(num_vertices=684, device=cuda_device)
    geom, consts = faust.faust_spline_op(next(iter(train))).args
    for csr, val in ((geom.fwd, consts["fwd"]), (geom.bwd, consts["bwd"])):
        for f in (1, 32, 64):
            _vs_plain(csr, val, torch.randn(csr.num_cols, f,
                                            device=cuda_device), 1e-5)


@pytest.mark.cuda
def test_faust_net_on_card_matches_cpu(cuda_device):
    """examples/faust.py's ``Net`` at 684 vertices: one forward and one
    backward through the spline operator on the card (6 + 5 ``spmm_csr``
    launches: conv1's input takes no gradient) against the same model
    on the CPU: logits and every parameter's gradient 1e-4."""
    from pytorch_geometric_tpu_torch.examples import faust
    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    train, _ = faust.load(num_vertices=684, device=cuda_device)
    graph = next(iter(train))
    cpu_graph = graph.to("cpu")
    nv = train.dataset[0].num_nodes
    net = faust.Net(nv, generator=torch.Generator().manual_seed(0))
    cpu_net = faust.Net(nv)
    cpu_net.load_state_dict(net.state_dict())
    net.to(cuda_device)
    op = faust.faust_spline_op(graph)
    before = launch_counts()["spmm_csr"]
    logits = net(graph, spline_op=op)
    torch.cuda.synchronize()
    assert launch_counts()["spmm_csr"] - before == 6
    faust.nll_loss(logits, graph).backward()
    torch.cuda.synchronize()
    assert launch_counts()["spmm_csr"] - before == 11
    want = cpu_net(cpu_graph, spline_op=faust.faust_spline_op(cpu_graph))
    faust.nll_loss(want, cpu_graph).backward()
    want = want.detach()
    err = float((logits.detach().cpu() - want).abs().max()
                / want.abs().max())
    assert err <= 1e-4, err
    cpu_params = dict(cpu_net.named_parameters())
    for name, p in net.named_parameters():
        b = cpu_params[name].grad
        err = float((p.grad.cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-4, (name, err)


def _scale_problem(device, n=600, f=40, seed=21):
    """A community-structured graph of ``n`` nodes (bench_scale.py's
    ``gen_clustered`` shape: 90% of the edges inside one of 3 contiguous
    communities), random weights, x."""
    from pytorch_geometric_tpu_torch.datasets.graphs import gen_clustered

    rng = np.random.default_rng(seed)
    s, r, _ = gen_clustered(n, 12 * n, 3, seed=seed)
    w = rng.normal(size=s.shape[0]).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    return s, r, w, x.to(device), n


@pytest.mark.cuda
def test_hybrid_spmm_on_card_matches_cpu(cuda_device):
    """``HybridSpmm`` on the card (two ``spmm_csr`` launches a direction:
    the dense part from bf16 x, the rest fp32) against the same operator
    on the CPU (1e-5: the same rounding points) and the fp32 plain sum
    (2e-2); ``dx`` and ``dw`` too; two calls bitwise equal."""
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.ops.hybrid_spmm import HybridSpmm
    from pytorch_geometric_tpu_torch.ops.spmm import spmm

    s, r, w, x, n = _scale_problem(cuda_device)
    op = HybridSpmm(s, r, n, window=64, tile=128, device=cuda_device)
    cpu = HybridSpmm(s, r, n, window=64, tile=128, device="cpu")
    assert len(op.parts) == 2 and 0.5 < op.dense_frac < 1.0
    wt = torch.from_numpy(w).to(cuda_device).requires_grad_()
    xt = x.clone().requires_grad_()
    before = launch_counts()["spmm_csr"]
    out = op(wt, xt)
    torch.cuda.synchronize()
    assert launch_counts()["spmm_csr"] - before == 2
    g = torch.randn_like(out)
    dw, dx = torch.autograd.grad(out, (wt, xt), g)
    assert launch_counts()["spmm_csr"] - before == 4
    wc = torch.from_numpy(w).requires_grad_()
    xc = x.cpu().requires_grad_()
    want = cpu(wc, xc)
    dwc, dxc = torch.autograd.grad(want, (wc, xc), g.cpu())
    for a, b in ((out, want), (dx, dxc), (dw, dwc)):
        err = float((a.detach().cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-5, err
    assert torch.equal(out, op(wt, xt))
    plain = spmm(torch.from_numpy(s), torch.from_numpy(r), x.cpu(), n,
                 weights=torch.from_numpy(w))
    err = float((out.detach().cpu() - plain).abs().max() / plain.abs().max())
    assert err <= 2e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_block_spmm_on_card_matches_cpu(cuda_device, compute):
    """``BlockSpmm`` on the card (the table built by one segment-sum
    launch, the dense part's window sums through the segment-sum kernel,
    the remainder through ``spmm_csr``) against the same operator on the
    CPU and the fp32 plain sum: fp32 1e-5; bf16 the table bitwise, the
    output and ``dx`` 1e-2 of the CPU's (cuBLAS and the CPU sum the bf16
    products in other orders) and 2e-2 of the plain sum. Two calls
    bitwise equal."""
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.ops.block_spmm import BlockSpmm
    from pytorch_geometric_tpu_torch.ops.spmm import spmm

    dt = torch.float32 if compute == "fp32" else torch.bfloat16
    tol = 1e-5 if compute == "fp32" else 1e-2
    s, r, w, x, n = _scale_problem(cuda_device)
    before = launch_counts()
    op = BlockSpmm(s, r, n, w, window=64, dense_threshold=200,
                   compute_dtype=dt, device=cuda_device)
    torch.cuda.synchronize()
    assert launch_counts()["sorted_segment_sum"] \
        - before["sorted_segment_sum"] == 1
    cpu = BlockSpmm(s, r, n, w, window=64, dense_threshold=200,
                    compute_dtype=dt, device="cpu")
    assert op.num_dense_blocks > 0 and op.sparse_edges > 0
    fn, consts = op.bind()
    cfn, cconsts = cpu.bind()
    assert torch.equal(consts["blocks"].cpu(), cconsts["blocks"])
    xt = x.clone().requires_grad_()
    before = launch_counts()
    out = fn(consts, xt)
    g = torch.randn_like(out)
    dx, = torch.autograd.grad(out, xt, g)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in ("spmm_csr",
                                              "sorted_segment_sum")} == \
        {"spmm_csr": 2, "sorted_segment_sum": 2}
    xc = x.cpu().requires_grad_()
    want = cfn(cconsts, xc)
    dxc, = torch.autograd.grad(want, xc, g.cpu())
    for a, b in ((out, want), (dx, dxc)):
        err = float((a.detach().cpu() - b).abs().max() / b.abs().max())
        assert err <= tol, err
    assert torch.equal(out, fn(consts, xt))
    plain = spmm(torch.from_numpy(s), torch.from_numpy(r), x.cpu(), n,
                 weights=torch.from_numpy(w))
    err = float((out.detach().cpu() - plain).abs().max() / plain.abs().max())
    assert err <= (1e-5 if compute == "fp32" else 2e-2), err


@pytest.mark.cuda
def test_mnist_graclus_net_on_card_matches_cpu(cuda_device):
    """examples/mnist_graclus.py's ``Net`` over one batch of 64 graphs:
    one forward and one backward through the batch's operators on the
    card (``spmm_csr`` 2 forward + 1 ``dx``; the segment sum 3 forward:
    both pools' means of pos and the readout) against the same model on
    the CPU: logits and every parameter's gradient 1e-4."""
    from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg
    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    train, _ = mg.load(train_samples=64, device=cuda_device)
    graph = next(iter(train))
    cpu_graph = graph.to("cpu")
    net = mg.Net(generator=torch.Generator().manual_seed(0))
    cpu_net = mg.Net()
    cpu_net.load_state_dict(net.state_dict())
    net.to(cuda_device)
    ops = mg.mnist_operators(graph)
    before = launch_counts()
    logits = net(graph, ops=ops)
    mg.loss_of(logits, graph).backward()
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in ("spmm_csr",
                                              "sorted_segment_sum")} == \
        {"spmm_csr": 3, "sorted_segment_sum": 3}
    want = cpu_net(cpu_graph, ops=mg.mnist_operators(cpu_graph))
    mg.loss_of(want, cpu_graph).backward()
    want = want.detach()
    err = float((logits.detach().cpu() - want).abs().max()
                / want.abs().max())
    assert err <= 1e-4, err
    cpu_params = dict(cpu_net.named_parameters())
    for name, p in net.named_parameters():
        b = cpu_params[name].grad
        err = float((p.grad.cpu() - b).abs().max() / b.abs().max())
        assert err <= 1e-4, (name, err)
