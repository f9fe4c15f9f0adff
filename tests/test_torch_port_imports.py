"""The PyTorch port stands alone and never hides the device: importing
every module of it loads no JAX and nothing of the JAX package; entry
points default to CUDA and raise where there is none; the kernel wrapper
computes on the CPU without counting a launch and refuses other devices;
``chip_smoke.py`` fails, and prints no result, without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.kernels import _build
from pytorch_geometric_tpu_torch.models.citation import train_gat, train_gcn
from pytorch_geometric_tpu_torch.models.entities import train_rgcn
from pytorch_geometric_tpu_torch.nn.conv import gat_dense_adj, gat_edge_set
from pytorch_geometric_tpu_torch.ops import (
    bsr_gat, flash_gat, fused_gcn, packed_rgcn, sorted_spmm)
from pytorch_geometric_tpu_torch.ops.csr import build_csr
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, spmm_csr, spmm_csr_plain)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import pytorch_geometric_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "pytorch_geometric_tpu",
              "networkx", "sklearn", "matplotlib"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _tiny_graph():
    rng = np.random.default_rng(0)
    n = 12
    mask = np.ones(n, bool)
    return Data(x=rng.random((n, 3)).astype(np.float32),
                edge_index=np.stack([rng.integers(0, n, 30),
                                     rng.integers(0, n, 30)]),
                y=rng.integers(0, 2, n), train_mask=mask, val_mask=mask,
                test_mask=mask)


def _tiny_relational_graph():
    rng = np.random.default_rng(2)
    n, e = 20, 60
    return Data(edge_index=np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
                edge_type=rng.integers(0, 3, e), y=rng.integers(0, 2, n),
                train_idx=np.arange(8), test_idx=np.arange(8, 12),
                num_nodes=n)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, imported in a fresh process, loads no
    JAX, nothing of the JAX package, no networkx, no sklearn and no
    matplotlib (which the card's machine does not have:
    ``utils/networkx_convert.py`` and the research layer's plots import
    networkx and matplotlib inside their functions, its spectral
    clustering sklearn; the weight correction keeps its graphs in
    ``research/spectral.py:WeightGraph``; the graph autoencoders and the
    infomax probe score with the port's own numpy AUC, AP and logistic
    regression)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("models.citation", "kernels._build", "ops.packed_gat",
                 "nn.conv.gat_conv", "datasets.molecules",
                 "ops.packed_rgcn", "nn.conv.rgcn_conv", "models.entities",
                 "ops.flash_gat", "ops.bsr_gat", "utils.reorder",
                 "ops.sorted_spmm", "ops.fused_gcn", "profiling", "debug",
                 "bounds", "datasets.graphs", "nn.message_passing",
                 "ops.sddmm", "nn.layers", "nn.conv.sg_conv",
                 "nn.conv.agnn_conv", "nn.conv.arma_conv",
                 "nn.conv.spline_conv", "nn.conv.dna_conv",
                 "nn.conv.graph_conv", "nn.conv.gin_conv",
                 "nn.conv.sage_conv", "nn.conv.cheb_conv",
                 "nn.conv.nn_conv", "nn.conv.edge_conv",
                 "nn.conv.point_conv", "transforms.geometry",
                 "utils.repeat", "utils.softmax", "utils.undirected",
                 "examples.citation_suite", "data.dataset", "data.loader",
                 "datasets.ppi", "datasets.tu_dataset", "datasets.synthetic",
                 "datasets.planetoid", "transforms.compose",
                 "transforms.structure", "utils.convert",
                 "utils.normalized_cut", "utils.k_hop_subgraph",
                 "utils.networkx_convert", "examples.ppi", "cluster",
                 "cluster._native", "transforms.points",
                 "transforms.coarsen_levels", "datasets.io",
                 "datasets.meshes", "datasets.large_graphs",
                 "examples.faust", "nn.norm", "nn.pool",
                 "nn.pool.global_pool", "nn.pool.topk_pool",
                 "nn.pool.set2set", "nn.pool.diff_pool", "nn.pool.coarsen",
                 "models.graph_pred", "nn.models", "nn.models.autoencoder",
                 "nn.models.infomax", "examples.mutag_gin",
                 "examples.enzymes_topk_pool", "examples.enzymes_diff_pool",
                 "examples.qm9_nn_conv", "examples.autoencoder",
                 "examples.infomax", "ops.hybrid_spmm", "ops.block_spmm",
                 "examples.mnist_graclus", "examples.mnist_voxel_grid",
                 "examples.mnist_nn_conv", "examples.pointnet2",
                 "data.closure", "data.sampler", "data.neighbor_loader",
                 "ops.embed_spmm", "utils.optim", "examples.reddit_sage",
                 "models.prunable", "research", "research.pruning",
                 "research.spectral", "research.link_prediction",
                 "research.checkpoint", "research.driver",
                 "research.fiedler_sgd", "research.admm",
                 "research.quantization", "research.spectral_cluster",
                 "research.plotting", "research.visualization",
                 "examples.mygcn", "parallel", "parallel.mesh",
                 "parallel.data_parallel", "parallel.partition",
                 "parallel.fast", "parallel.api", "parallel.models",
                 "examples.data_parallel", "examples.mnist_data_parallel",
                 "examples.distributed_gcn", "tools", "tools.common",
                 "tools.gat_sweep", "tools.rgcn_sweep",
                 "tools.profile_epoch", "tools.probe_reddit",
                 "tools.sparse_tail_probe", "tools.reddit_threshold_probe",
                 "tools.adv_asym_probe", "tools.gen_api_docs"):
        assert f"pytorch_geometric_tpu_torch.{name}" in report["modules"]
    assert report["bad"] == []


_IMPORT_PROBES = """
import importlib, json, pathlib, sys
names = ["probes"] + sorted("probes." + p.stem for p in
                            pathlib.Path("probes").glob("*.py")
                            if p.stem != "__init__")
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "pytorch_geometric_tpu",
              "chip_smoke"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_probes_import_no_jax_and_nothing_of_the_jax_package():
    """Every module of ``probes/`` imports on the CPU (building and
    launching nothing) without JAX, the JAX package or ``chip_smoke``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("common", "gat_ablate", "rgcn_ablate", "rgcn_pipe_probe",
                 "fused_gcn_designs"):
        assert f"probes.{name}" in report["modules"]
    assert report["bad"] == []


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _tiny_graph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_data(data)
    graph = from_data(data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gcn(graph, num_classes=2, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpmmOperator(graph.senders, graph.receivers, graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gat(graph, num_classes=2, epochs=1)
    s, r = gat_edge_set(graph)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackedFlashGat(senders=s, receivers=r, num_nodes=graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gat(graph, num_classes=2, epochs=1, backend="dense")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flash_gat.FlashGatOperator(gat_dense_adj(graph))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gat(graph, num_classes=2, epochs=1, backend="bsr")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bsr_gat.BsrFlashGat(gat_dense_adj(graph))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bsr_gat.BsrFlashGat.from_edges(*gat_edge_set(graph), graph.num_nodes)
    for backend in ("sorted", "fused", "dense", "hybrid"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_gcn(graph, num_classes=2, epochs=1, backend=backend)
    from pytorch_geometric_tpu_torch.ops.block_spmm import (
        BlockSpmm, BlockStructure)
    from pytorch_geometric_tpu_torch.ops.hybrid_spmm import HybridSpmm

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HybridSpmm(graph.senders, graph.receivers, graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockStructure(graph.senders, graph.receivers, graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockSpmm(graph.senders, graph.receivers, graph.num_nodes,
                  np.ones(graph.num_edges, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sorted_spmm.SortedSpmm(graph.senders, graph.receivers,
                               graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sorted_spmm.SortedSegmentSum(graph.receivers, graph.num_nodes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_gcn.FusedGcn2(graph.senders, graph.receivers, graph.num_nodes,
                            np.ones(graph.num_edges, np.float32), hidden=4,
                            classes=2)
    from pytorch_geometric_tpu_torch.examples import ppi

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppi.run(epochs=1)
    from pytorch_geometric_tpu_torch.examples import faust
    from pytorch_geometric_tpu_torch.ops.spmm import pack_bipartite_tables

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        faust.run(epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_bipartite_tables([0], [1], 1, 2, [1.0])
    from pytorch_geometric_tpu_torch.examples import (
        autoencoder, enzymes_diff_pool, enzymes_topk_pool, infomax,
        mutag_gin, qm9_nn_conv)

    from pytorch_geometric_tpu_torch.examples import (
        mnist_graclus, mnist_nn_conv, mnist_voxel_grid, pointnet2)

    for module in (mutag_gin, enzymes_topk_pool, enzymes_diff_pool,
                   qm9_nn_conv, autoencoder, infomax, mnist_graclus,
                   mnist_voxel_grid, mnist_nn_conv, pointnet2):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.run(epochs=1)
    rel = from_data(_tiny_relational_graph(), device="cpu")
    edges = (rel.senders, rel.receivers, rel.edge_type, 3, rel.num_nodes,
             np.ones(rel.num_edges, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_rgcn(rel, 3, 2, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        packed_rgcn.PackedRgcnSpmm(*edges)
    # the closures, the sampler, the table SpMM and reddit_sage
    from pytorch_geometric_tpu_torch.data.closure import (
        layered_training_closure)
    from pytorch_geometric_tpu_torch.data.neighbor_loader import (
        NeighborSampler)
    from pytorch_geometric_tpu_torch.examples import reddit_sage
    from pytorch_geometric_tpu_torch.ops.embed_spmm import EmbedSpmm

    ei = np.stack([graph.senders.numpy(), graph.receivers.numpy()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        layered_training_closure(ei, [0, 1], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gcn(graph, num_classes=2, epochs=1, closure=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gat(graph, num_classes=2, epochs=1, closure=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_rgcn(rel, 3, 2, epochs=1, closure=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NeighborSampler(ei[0], ei[1], graph.num_nodes, sizes=[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbedSpmm([0, 1], [1, 0], 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reddit_sage.run(epochs=1)
    # the research layer: its pipelines, mygcn and the Fiedler power
    # iteration (the weight graph of one 2 x 2 layer)
    from pytorch_geometric_tpu_torch.examples import mygcn
    from pytorch_geometric_tpu_torch.research import driver, spectral

    for run in (driver.training_net, driver.training_net_ppi,
                lambda: driver.training_net_graphcls("ENZYMES"), mygcn.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    G, _ = spectral.weights_to_adjacency(np.eye(2, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spectral.compute_fiedler_vector(G, use_device=True)
    # data parallelism and the edge partition: NCCL ranks on the cards
    from pytorch_geometric_tpu_torch.examples import (
        data_parallel, distributed_gcn, mnist_data_parallel)
    from pytorch_geometric_tpu_torch.parallel.mesh import RankPool

    for run in (data_parallel.run, mnist_data_parallel.run,
                distributed_gcn.run, lambda: RankPool(1),
                lambda: driver.training_net_partitioned("Cora", "GCN", 2),
                lambda: driver.training_net_graphcls("MUTAG",
                                                     num_devices=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_cpu_wrapper_computes_plain_and_counts_no_launch():
    spmm_csr.launches = 0
    rng = np.random.default_rng(1)
    s, r = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    csr = build_csr(r, s, 40)
    val = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    out = spmm_csr(csr, val, x)
    assert torch.equal(out, spmm_csr_plain(csr, val, x))
    graph = from_data(_tiny_graph(), device="cpu")
    train_gcn(graph, num_classes=2, epochs=3, device="cpu")
    assert spmm_csr.launches == 0


def test_cpu_rgcn_wrappers_compute_plain_and_count_no_launch():
    fwd, bwd = packed_rgcn.packed_rgcn_fwd, packed_rgcn.packed_rgcn_bwd
    fwd.launches = bwd.launches = 0
    rel = from_data(_tiny_relational_graph(), device="cpu")
    n = rel.num_nodes
    op = packed_rgcn.PackedRgcnSpmm(
        rel.senders, rel.receivers, rel.edge_type, 3, n,
        np.ones(rel.num_edges, np.float32), device="cpu")
    gen = torch.Generator().manual_seed(0)
    xB, att, g = (torch.randn(shape, generator=gen)
                  for shape in ((n, 8), (3, 4), (n, 2)))
    out = fwd(op.fwd, op.send, xB, att)
    assert torch.equal(out, packed_rgcn.packed_rgcn_fwd_plain(
        op.fwd, op.fwd_et, op.fwd_w, xB, att))
    got = bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos, op.rel_ptr, xB, att,
              g)
    want = packed_rgcn.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w,
                                             xB, att, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    train_rgcn(rel, 3, 2, epochs=2, device="cpu")
    assert (fwd.launches, bwd.launches) == (0, 0)


def test_cpu_flash_gat_wrappers_compute_plain_and_count_no_launch():
    fwd, bwd = flash_gat.flash_gat_fwd, flash_gat.flash_gat_bwd
    fwd.launches = bwd.launches = 0
    graph = from_data(_tiny_graph(), device="cpu")
    n = graph.num_nodes
    adj = gat_dense_adj(graph)
    mask = flash_gat.BitMask(adj)
    gen = torch.Generator().manual_seed(0)
    d, s, h, g = (torch.randn(shape, generator=gen)
                  for shape in ((n, 2), (n, 2), (n, 6), (n, 6)))
    seed = torch.tensor([5], dtype=torch.int32)
    out, lse = fwd(mask, d, s, h, seed, 0.5)
    want = flash_gat.flash_gat_fwd_plain(adj, d, s, h, seed, 0.5)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    got = bwd(mask, d, s, h, lse, out, g, seed, 0.5)
    want = flash_gat.flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    train_gat(graph, num_classes=2, epochs=2, device="cpu", backend="dense")
    assert (fwd.launches, bwd.launches) == (0, 0)


def test_cpu_bsr_gat_wrappers_compute_plain_and_count_no_launch():
    wrappers = (bsr_gat.bsr_gat_fwd, bsr_gat.bsr_gat_bwd_row,
                bsr_gat.bsr_gat_bwd_col)
    for w in wrappers:
        w.launches = 0
    graph = from_data(_tiny_graph(), device="cpu")
    n = graph.num_nodes
    mask = bsr_gat.BlockMask(*gat_edge_set(graph)[::-1], n)
    gen = torch.Generator().manual_seed(0)
    d, s, h, g = (torch.randn(shape, generator=gen)
                  for shape in ((n, 2), (n, 2), (n, 6), (n, 6)))
    seed = torch.tensor([5], dtype=torch.int32)
    out, lse = bsr_gat.bsr_gat_fwd(mask, d, s, h, seed, 0.5)
    want = bsr_gat.bsr_gat_fwd_plain(mask, d, s, h, seed, 0.5)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    dd, big_d = bsr_gat.bsr_gat_bwd_row(mask, d, s, h, lse, out, g, seed, 0.5)
    ds, dh = bsr_gat.bsr_gat_bwd_col(mask, d, s, h, lse, big_d, g, seed, 0.5)
    want = bsr_gat.bsr_gat_bwd_plain(mask, d, s, h, lse, out, g, seed, 0.5)
    assert all(torch.equal(a, b) for a, b in zip((dd, ds, dh), want))
    train_gat(graph, num_classes=2, epochs=2, device="cpu", backend="bsr")
    assert [w.launches for w in wrappers] == [0, 0, 0]


def test_cpu_gcn_backend_wrappers_compute_plain_and_count_no_launch():
    wrappers = (sorted_spmm.sorted_segment_sum, fused_gcn.fused_gcn_fwd,
                fused_gcn.fused_gcn_bwd, spmm_csr)
    for w in wrappers:
        w.launches = 0
    graph = from_data(_tiny_graph(), device="cpu")
    n = graph.num_nodes
    op = fused_gcn.FusedGcn2(graph.senders, graph.receivers, n,
                             np.ones(graph.num_edges, np.float32), hidden=4,
                             classes=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    z1, W2, b1, g2, msgs = (torch.randn(shape, generator=gen)
                            for shape in ((n, 4), (4, 2), (4,), (n, 2),
                                          (op.op.fwd.num_edges, 3)))
    seed = torch.tensor([5], dtype=torch.int32)
    got = sorted_spmm.sorted_segment_sum(op.op.fwd.row_ptr, msgs)
    assert torch.equal(got, sorted_spmm.sorted_segment_sum_plain(
        op.op.fwd.row_ptr, msgs))
    fwd = (op.op.fwd, op.val_f, z1, W2, b1, seed, 0.5)
    h1_pre, out = fused_gcn.fused_gcn_fwd(*fwd)
    want = fused_gcn.fused_gcn_fwd_plain(*fwd)
    assert torch.equal(h1_pre, want[0]) and torch.equal(out, want[1])
    bwd = (op.op.bwd, op.val_b, g2, W2, b1, h1_pre, seed, 0.5)
    got = fused_gcn.fused_gcn_bwd(*bwd)
    want = fused_gcn.fused_gcn_bwd_plain(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for backend in ("sorted", "fused", "dense"):
        train_gcn(graph, num_classes=2, epochs=2, device="cpu",
                  backend=backend)
    assert [w.launches for w in wrappers] == [0, 0, 0, 0]


def test_wrapper_refuses_other_devices_and_bad_inputs():
    csr = build_csr(np.array([0, 1]), np.array([1, 0]), 2)
    val = torch.ones(2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_csr(csr.to("meta"), val.to("meta"),
                 torch.ones(2, 4, device="meta"))
    with pytest.raises(TypeError):
        spmm_csr(csr, val, torch.ones(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        spmm_csr(csr, val, torch.ones(3, 4))
    with pytest.raises(ValueError):
        spmm_csr(csr, torch.ones(3), torch.ones(2, 4))


def test_kernel_build_is_described_not_run_at_import():
    assert sorted(_build.SIGNATURES) == [
        "bsr_gat", "flash_gat", "fused_gcn", "packed_gat", "packed_rgcn",
        "sorted_spmm", "spmm_csr"]
    assert list(_build.SIGNATURES["sorted_spmm"]) == ["sorted_segment_sum"]
    assert sorted(_build.SIGNATURES["fused_gcn"]) == [
        "fused_gcn_bwd", "fused_gcn_fwd"]
    assert sorted(_build.SIGNATURES["flash_gat"]) == [
        "flash_gat_bwd_col", "flash_gat_bwd_row", "flash_gat_fwd"]
    assert sorted(_build.SIGNATURES["bsr_gat"]) == [
        "bsr_gat_bwd_col", "bsr_gat_bwd_row", "bsr_gat_fwd"]
    header = _build.SOURCE_DIR / "gat_mask.cuh"
    for name in _build.SIGNATURES:
        files = _build.source_files(name)
        assert files[0] == _build.SOURCE_DIR / f"{name}.cu"
        assert all(f.is_file() for f in files)
        assert (header in files) == (name in ("flash_gat", "bsr_gat"))
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "/pytorch_geometric_tpu_torch/_build/" in ignored


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    """The library's name hashes every file its source includes, so an
    edited header is never served by an old library; and the package
    data ships the header with the sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, csrc)
    monkeypatch.setattr(_build, "SOURCE_DIR", csrc)
    names = list(_build.SIGNATURES)
    before = {name: _build.library_path(name) for name in names}
    assert before == {name: path for name, path in before.items()
                      if path.parent == _build.BUILD_DIR}
    with open(csrc / "gat_mask.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in names}
    changed = sorted(name for name in names if after[name] != before[name])
    assert changed == ["bsr_gat", "flash_gat"]
    with open(csrc / "spmm_csr.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("spmm_csr") != after["spmm_csr"]
    assert _build.library_path("bsr_gat") == after["bsr_gat"]
    pyproject = (REPO / "pyproject.toml").read_text()
    assert '"csrc/*.cu", "csrc/*.cuh"' in pyproject


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_citation_suite_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from pytorch_geometric_tpu_torch.examples import citation_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = from_data(_tiny_graph(), device="cpu")
    for name in citation_suite.MODELS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            citation_suite.train_suite(name, graph, 2, epochs=1)


def test_a_failed_graphcore_build_raises(tmp_path, monkeypatch):
    """The native library is built into the build directory, and a build
    that fails raises: no cluster function falls back to numpy."""
    from pytorch_geometric_tpu_torch import cluster
    from pytorch_geometric_tpu_torch.cluster import _native

    assert _native.BUILD_DIR == _build.BUILD_DIR
    assert "-march=native" not in _native.CXX_FLAGS
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="graphcore build failed"):
        cluster.fps(np.zeros((4, 3)))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "CXX", "g++")
    monkeypatch.setattr(_native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="exited"):
        cluster.knn_graph(np.zeros((4, 3)), 2)
    assert list(tmp_path.glob("*.so")) == []
    assert list(tmp_path.glob("*.tmp")) == []


@pytest.mark.parametrize("name", [
    "gat_sweep", "rgcn_sweep", "profile_epoch", "probe_reddit",
    "sparse_tail_probe", "reddit_threshold_probe", "adv_asym_probe"])
def test_tools_default_to_cuda_and_raise_without_it(monkeypatch, name):
    """Each tool script runs on the card unless ``--device cpu`` is
    passed, and without a card raises before it builds or draws
    anything."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(
        f"pytorch_geometric_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])
