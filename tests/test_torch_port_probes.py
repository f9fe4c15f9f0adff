"""The kernel probes under ``probes/`` on the CPU, where they cannot run
(their kernels need the card): their graphs
(``pytorch_geometric_tpu_torch/datasets/graphs.py``, which
``chip_smoke.py`` builds too) against the JAX package's (bit for bit),
their modes against the bits the CUDA sources test, their
defaults, their build through ``kernels/_build.py:build_source``, and
their refusal to run without a card. The card tests of the probes are in
``tests/test_torch_port_kernels.py``."""

import inspect
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.datasets import Entities as JEntities
from pytorch_geometric_tpu.transforms import (
    NormalizeFeatures as JNormalizeFeatures)
from pytorch_geometric_tpu.utils.reorder import (
    rcm_permutation as j_rcm_permutation)
from pytorch_geometric_tpu.utils.reorder import reorder_graph as j_reorder
from pytorch_geometric_tpu_torch.datasets import Entities, Planetoid
from pytorch_geometric_tpu_torch.datasets import graphs
from pytorch_geometric_tpu_torch.kernels import _build
from probes import (bsr_gat_designs, bsr_gat_variants, flash_gat_designs,
                    fused_gcn_designs, gat_ablate, packed_gat_designs,
                    parity_tail,
                    packed_gat_variants,
                    packed_rgcn_designs, rgcn_ablate, rgcn_pipe_probe,
                    chunk_map_variants, segment_sum_designs,
                    spmm_csr_designs)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ["gat_ablate.py", "rgcn_ablate.py", "rgcn_pipe_probe.py",
           "fused_gcn_designs.py", "bsr_gat_designs.py",
           "bsr_gat_variants.py", "packed_gat_designs.py",
           "packed_gat_variants.py", "flash_gat_designs.py",
           "packed_rgcn_designs.py", "spmm_csr_designs.py",
           "segment_sum_designs.py", "chunk_map_variants.py",
           "parity_tail.py"]


def _jax_mutag_rcm(root, scale):
    """``tools/rgcn_sweep.py:build_graph``'s relabelling, with the JAX
    package, at ``root`` and ``scale``."""
    data = JEntities(str(root), "MUTAG", scale=scale)[0]
    ei = np.asarray(data.edge_index)
    n = data.num_nodes
    perm = j_rcm_permutation(ei[0], ei[1], n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    data.edge_index = inv[ei]
    data.y = np.asarray(data.y)[perm]
    data.train_idx = inv[np.asarray(data.train_idx)]
    data.test_idx = inv[np.asarray(data.test_idx)]
    return data


def test_rgcn_probe_graph_rcm_matches_the_jax_chain(tmp_path):
    _, data = graphs.mutag_data("rcm", scale=0.01)
    _, graph = graphs.mutag_graph("cpu", "rcm", scale=0.01)
    want = _jax_mutag_rcm(tmp_path, 0.01)
    for key in ("edge_index", "y", "train_idx", "test_idx"):
        np.testing.assert_array_equal(np.asarray(data[key]),
                                      np.asarray(want[key]), err_msg=key)
    jg = j_from_data(want)
    np.testing.assert_array_equal(graph.senders.numpy(),
                                  np.asarray(jg.senders))
    np.testing.assert_array_equal(graph.receivers.numpy(),
                                  np.asarray(jg.receivers))


def test_rgcn_probe_graph_as_trained_is_the_dataset_order():
    _, data = graphs.mutag_data("as_trained", scale=0.01)
    _, graph = graphs.mutag_graph("cpu", "as_trained", scale=0.01)
    plain = Entities(str(graphs.MUTAG_ROOT), "MUTAG", scale=0.01)[0]
    for key in ("edge_index", "edge_type", "y", "train_idx", "test_idx"):
        np.testing.assert_array_equal(data[key], plain[key], err_msg=key)
    assert graph.senders.device.type == "cpu"
    with pytest.raises(ValueError, match="order"):
        graphs.mutag_data("degree", scale=0.01)


def test_gat_probe_graph_matches_the_jax_reorder_chain():
    raw = Planetoid(str(graphs.PLANETOID_ROOT), "Cora")[0]
    jdata = j_reorder(JNormalizeFeatures()(JData(**dict(raw()))))
    _, data, seconds = graphs.pubmed_data("Cora")
    assert seconds >= 0
    assert sorted(data.keys) == sorted(jdata.keys)
    for key in data.keys:
        np.testing.assert_allclose(np.asarray(data[key]),
                                   np.asarray(jdata[key]), rtol=0, atol=0,
                                   err_msg=key)
    _, graph, _ = graphs.pubmed_graph("cpu", name="Cora")
    jg = j_from_data(jdata)
    for key in ("senders", "receivers", "x"):
        np.testing.assert_array_equal(getattr(graph, key).numpy(),
                                      np.asarray(getattr(jg, key)),
                                      err_msg=key)


def _namespace_bits(source: str, namespace: str):
    """{constant: bit} of ``constexpr unsigned kX = 1u << n;`` inside
    ``namespace <namespace> { ... }``."""
    body = re.search(r"namespace %s \{(.*?)\}" % namespace, source,
                     re.S).group(1)
    return {name: 1 << int(shift) for name, shift in re.findall(
        r"constexpr unsigned (k\w+) = 1u << (\d+);", body)}


@pytest.mark.parametrize("probe,csrc,probe_cu,namespace", [
    (gat_ablate, "packed_gat.cu", "packed_gat_ablate.cu", "gat_ablate"),
    (rgcn_ablate, "packed_rgcn.cu", "packed_rgcn_ablate.cu", "rgcn_ablate")])
def test_each_mode_is_a_bit_that_the_source_tests(probe, csrc, probe_cu,
                                                  namespace):
    """``full`` is 0; every other mode is one bit of the production
    source's mask, named alike (``nogather_s`` <-> ``kNoGatherS``), that
    is tested outside its definition (by the kernel in the production
    source, or by the probe's launches, as ``kNoDatt`` skips the datt
    reduction) and that the probe source instantiates. Every bit but
    ``kNoDatt`` is tested inside the backward kernel that ships (for the
    RGCN, the one walk ``rgcn_bwd_kernel``)."""
    source = (_build.SOURCE_DIR / csrc).read_text()
    probe_source = (REPO / "probes" / probe_cu).read_text()
    bits = _namespace_bits(source, namespace)
    assert probe.MODES["full"] == 0
    modes = {m: b for m, b in probe.MODES.items() if m != "full"}
    assert sorted(modes.values()) == sorted(bits.values())
    assert len(set(modes.values())) == len(modes)
    for mode, bit in modes.items():
        (name,) = [k for k, v in bits.items() if v == bit]
        assert name[1:].lower() == mode.replace("_", ""), (mode, name)
        uses = len(re.findall(r"\b%s\b" % name, source)) + len(
            re.findall(r"(?<!PROBE_MODE\()\b%s\b" % name, probe_source))
        assert uses >= 2, f"{name} is defined but never tested"
        assert f"PROBE_MODE({name})" in probe_source
    assert f'#include "../pytorch_geometric_tpu_torch/csrc/{csrc}"' \
        in probe_source
    kernel = "gat_bwd_kernel(" if namespace == "gat_ablate" \
        else "rgcn_bwd_kernel("
    start = source.index("\n" + kernel)
    body = source[start:source.index("\n}\n", start)]
    for name in bits:
        if name != "kNoDatt":
            assert re.search(r"\b%s\b" % name, body), (kernel, name)


def test_the_prefetch_depth_defaults_to_one():
    """Depth 1 is the default and the library's forward,
    ``packed_rgcn_fwd`` itself; the deeper walk lives in the probe
    source, and the library launches the sender-major message walk
    forward and the unablated backward only."""
    params = inspect.signature(rgcn_pipe_probe.pipe_fwd).parameters
    assert params["depth"].default == 1
    assert rgcn_pipe_probe.DEPTHS[0] == 1
    source = (_build.SOURCE_DIR / "packed_rgcn.cu").read_text()
    probe_source = (REPO / "probes" / "packed_rgcn_ablate.cu").read_text()
    assert "kDepth" not in source
    assert "rgcn_msg_ahead_kernel<CP, G, kDepth>" in probe_source
    assert re.search(r"if \(depth == 1\) \{\s*return packed_rgcn_fwd\(",
                     probe_source)
    assert "rgcn_fwd_kernel<CP><<<" not in source
    assert "\nrgcn_fwd_kernel(" in source
    assert "rgcn_msg_kernel<CP, G, true>" in source
    assert "rgcn_bwd_kernel<CP><<<" in source
    with pytest.raises(ValueError, match="depth"):
        rgcn_pipe_probe.pipe_fwd(None, None, None, None, depth=3)


def test_the_pipe_probe_prefetches_on_the_shipped_message_walk():
    """The prefetch kernel is the library's message walk
    (``rgcn_msg_kernel``) with its loads ahead: the probe source includes
    ``csrc/packed_rgcn.cu``, its walk makes the library's multiply-adds
    and stores with the library's expressions, over the sender-major CSR,
    with the library's launch bounds and grid, and follows it with the
    library's segment sum; no copy of the receiver-major first design's
    walk is left."""
    probe_source = (REPO / "probes" / "packed_rgcn_ablate.cu").read_text()
    source = (_build.SOURCE_DIR / "packed_rgcn.cu").read_text()
    assert '#include "../pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu"' \
        in probe_source
    assert [p.name for p in _build._included(rgcn_ablate.SOURCE)] == [
        "packed_rgcn_ablate.cu", "packed_rgcn.cu", "segment_sum.cuh",
        "row_lanes.cuh"]
    for line in ("part = grp.sum_from(part, CP);",
                 "msg[static_cast<size_t>(pk) * C + c] = wk * part;",
                 "const int t = grp.bcast(my_et, k);",
                 "__launch_bounds__(kThreads, kMsgMinBlocks)"):
        assert line in source and line in probe_source, line
    walk = probe_source[probe_source.index("rgcn_msg_ahead_kernel("):]
    assert "msg_request<CP, LR, KS>(ring[(s + kDepth - 1) % kDepth]" in walk
    assert "<<<msg_blocks(n_send, G), kThreads, smem, st>>>" in probe_source
    assert "segment_sum::dispatch(" in probe_source
    assert "rgcn_fwd_kernel" not in probe_source
    assert "rgcn_fwd_ahead_kernel" not in probe_source
    sig = rgcn_ablate.SIGNATURES["packed_rgcn_pipe_fwd"]
    lib = _build.SIGNATURES["packed_rgcn"]["packed_rgcn_fwd"]
    assert sig[1] == lib[1][:-1] + [lib[1][-2]] + lib[1][-1:]
    doc = rgcn_pipe_probe.__doc__
    assert "depth 1 is the shipped forward" in doc
    assert "--shapes" in doc and "--depths" in doc and "--order" in doc


@pytest.mark.parametrize("natural,want", [
    ({"full": 4, "nogather_g": 8, "noexp": 4}, (45 * 1024, 4)),
    ({"full": 5, "nodxb_walk": 8, "noindex": 3}, (38 * 1024, 5)),
    ({"full": 4, "noexp": 4}, (0, 4))])
def test_occupancy_padding_is_the_least_that_caps_every_mode(natural, want):
    """Against a model of an SM with 228 KB of shared memory and 1 KB
    reserved per block: the least padding that caps every mode at
    ``full``'s blocks, none where no mode exceeds it; a mode with fewer
    blocks than ``full`` (more registers) keeps its count."""
    from probes.common import occupancy_padding

    def blocks(mode, smem):
        return min(natural[mode], 228 * 1024 // (smem + 1024))

    smem, target = occupancy_padding(blocks, list(natural))
    assert (smem, target) == want
    assert blocks("full", smem) == target
    assert all(blocks(m, smem) == min(n, target)
               for m, n in natural.items())
    with pytest.raises(RuntimeError, match="no padding"):
        occupancy_padding(lambda m, sm: 8 if m != "full" else 4,
                          list(natural))


@pytest.mark.parametrize("script", SCRIPTS)
def test_each_probe_exits_nonzero_without_a_card(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "probes" / script)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("probe,argv", [
    (gat_ablate, ["--modes", "full,noonehot"]),
    (rgcn_ablate, ["--order", "random"]),
    (rgcn_pipe_probe, ["--depths", "1,3"]),
    (bsr_gat_variants, ["--variants", "rows4,rows8"]),
    (packed_gat_variants, ["--variants", "edges2,edges3"]),
    (packed_gat_designs, ["--graphs", "cora,ppi"]),
    (flash_gat_designs, ["--cases", "cora,pubmed"]),
    (packed_rgcn_designs, ["--cases", "conv1,conv3"]),
    (spmm_csr_designs, ["--cases", "cora,citeseer"]),
    (segment_sum_designs, ["--cases", "dna,gcn"]),
    (chunk_map_variants, ["--variants", "spmm_edges4,spmm_edges9"])])
def test_probes_refuse_unknown_modes_orders_and_depths(probe, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        probe.main(argv)
    assert exc.value.code == 2
    assert "unknown" in capsys.readouterr().err


def test_parity_tail_runs_the_gates_of_the_tree_it_is_given():
    """``probes/parity_tail.py`` runs, in a process a hash seed, the
    tree's own card-against-CPU comparison of ``slice_driver_gat``
    (``driver_steps_logits`` at the widths ``training_net`` draws, against
    ``DRIVER_PARITY_TOL["GAT"]``, 1e-3) or of ``slice_infomax``
    (``infomax_steps_z`` against ``INFOMAX_PARITY_TOL``, 1e-4), through
    ``chip_smoke._parity``, as the phases do; no tolerance of its own."""
    import chip_smoke

    assert parity_tail.parse_seeds("0-9") == list(range(10))
    assert parity_tail.parse_seeds("3,7") == [3, 7]
    assert parity_tail.GATES == ("driver_gat", "infomax")
    assert chip_smoke.DRIVER_PARITY_TOL["GAT"] == 1e-3
    assert chip_smoke.INFOMAX_PARITY_TOL == 1e-4
    child = parity_tail.CHILD
    for name in ("driver_steps_logits", "infomax_steps_z",
                 "DRIVER_PARITY_TOL", "INFOMAX_PARITY_TOL", "_parity"):
        assert f"cs.{name}" in child and hasattr(chip_smoke, name)
    assert "contraction_layer_coefficients(graph.num_node_features, 2, 0.5" \
        in child
    source = Path(chip_smoke.__file__).read_text()
    assert "_parity(infomax_steps_z)" in source
    assert "parity <= INFOMAX_PARITY_TOL" in source
    assert "parity <= DRIVER_PARITY_TOL[model_name]" in source


@pytest.mark.parametrize("gaps,passes,first", [
    ({"3": 2e-4}, True, None),
    ({"3": 7e-3, "1": 3e-6, "2": 4e-4}, False, 2),
    ({"3": 7e-3, "1": 2e-5, "2": 4e-4}, False, 1)])
def test_parity_tail_reads_a_seed(monkeypatch, gaps, passes, first):
    """One seed's line: the three-step gap against the tree's tolerance,
    and, where the gate fails, the first step whose gap passes 1e-5; the
    child runs in the tree's root with the seed as its hash seed and the
    gate as its argument."""
    import json

    seen = {}

    def fake_run(cmd, cwd, env, capture_output, text):
        seen.update(cwd=cwd, seed=env["PYTHONHASHSEED"], args=cmd[-2:])
        out = json.dumps({"tol": 1e-3, "gaps": gaps})
        return subprocess.CompletedProcess(cmd, 0, stdout=out + "\n",
                                           stderr="")

    monkeypatch.setattr(parity_tail.subprocess, "run", fake_run)
    row = parity_tail.run_seed("/some/tree", "driver_gat", 4)
    assert seen == {"cwd": "/some/tree", "seed": "4",
                    "args": ["driver_gat", "3,1,2"]}
    assert row["passes"] is passes
    assert row["first_step_over_1e-5"] == first
    assert row["gap_steps"][3] == gaps["3"]


def test_build_source_follows_includes_into_csrc(tmp_path, monkeypatch):
    """A probe's library name hashes the production source it includes:
    an edit there is never served by an old probe library."""
    (tmp_path / "probes").mkdir()
    csrc = tmp_path / "pytorch_geometric_tpu_torch" / "csrc"
    shutil.copytree(_build.SOURCE_DIR, csrc)
    for name in ("packed_gat_ablate.cu", "packed_rgcn_ablate.cu"):
        shutil.copy(REPO / "probes" / name, tmp_path / "probes" / name)
    monkeypatch.setattr(_build, "SOURCE_DIR", csrc)
    gat = tmp_path / "probes" / "packed_gat_ablate.cu"
    rgcn = tmp_path / "probes" / "packed_rgcn_ablate.cu"
    assert [p.name for p in _build._included(gat)] == [
        "packed_gat_ablate.cu", "packed_gat.cu", "row_lanes.cuh"]
    before = {p: _build._library_of(p) for p in (gat, rgcn)}
    assert before[gat].name.startswith("libpacked_gat_ablate-")
    assert before[gat].parent == _build.BUILD_DIR
    with open(csrc / "packed_gat.cu", "a") as f:
        f.write("// edited\n")
    assert _build._library_of(gat) != before[gat]
    assert _build._library_of(rgcn) == before[rgcn]
    # the repo's own probe sources name their production sources alike
    assert _build._library_of(REPO / "probes" / "packed_gat_ablate.cu") \
        == before[gat]


def test_fused_gcn_designs_builds_through_build_source():
    """The design probe takes its timer from ``profiling.py`` and builds
    through ``build_source`` (one cached library per source state, no
    per-process copy); no probe imports ``chip_smoke``."""
    import ast

    for path in (REPO / "probes").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for node in ast.walk(tree)
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in node.names}
        mods = {node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)}
        assert "chip_smoke" not in names | mods, path.name
    text = (REPO / "probes" / "fused_gcn_designs.py").read_text()
    assert "build_source(SOURCE, SIGNATURES)" in text
    assert "getpid" not in text


def test_fused_gcn_designs_times_the_shipped_design_beside_the_new_one():
    """The fused GCN's design probe includes the production source (so
    the shipped walks are the library's own code, launched with the
    library's arguments at other values of the constants the library
    fixes: lanes a row and edges a lane loads at once, as the library's
    two launches, two plain ones, or both walks in one cooperative launch
    at 1-4 blocks an SM) and keeps the earlier design verbatim in its own
    namespace with the library's arguments; its library name hashes
    ``csrc/fused_gcn.cu`` and ``row_lanes.cuh``, and its cases cover both
    graphs and rates of the main path's calls at every lane count and
    grid. The library's walks are the CSR SpMM's row walk."""
    source = fused_gcn_designs.SOURCE.read_text()
    assert '#include "../pytorch_geometric_tpu_torch/csrc/fused_gcn.cu"' \
        in source
    assert "namespace earlier_design {" in source
    earlier = source[source.index("namespace earlier_design {"):
                     source.index("}  // namespace earlier_design")]
    # the earlier design: the serial walk, the per-node pass, two barriers
    assert "for (int e = e0; e < e1; ++e) {" in earlier
    assert "transform_fwd(p);" in earlier and "transform_bwd(p);" in earlier
    assert earlier.count("grid.sync();") == 2
    # the shipped walks through the library's own set-up and launches
    assert "return with_shape<kBwd, NB>(p, lanes," in source
    assert "return launch_walks<kBwd, L, V, NB>(q, s);" in source
    assert "return launch_plain<kBwd, L, V, NB>(q, s);" in source
    assert "earlier_design::launch<true>(p, s)" in source
    assert [p.name for p in _build._included(fused_gcn_designs.SOURCE)] == [
        "fused_gcn_designs.cu", "fused_gcn.cu", "row_lanes.cuh"]
    # the direction, then the library backward's arguments (the forward's
    # have no h1_pre: the probe passes None); the design's knobs before
    # the stream
    import ctypes

    lib = _build.SIGNATURES["fused_gcn"]["fused_gcn_bwd"]
    earlier_sig = fused_gcn_designs.SIGNATURES["probe_earlier"]
    design = fused_gcn_designs.SIGNATURES["probe_design"]
    assert earlier_sig[1] == [ctypes.c_int] + lib[1]
    assert design[1] == earlier_sig[1][:-1] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    names = fused_gcn_designs.variants()
    assert names["earlier"] is None
    assert {f"coop_l{lanes}_b{bps}_e{nb}" for lanes in (4, 8, 16)
            for bps in (1, 2, 4) for nb in (4, 8)} | {
        f"{form}_l{lanes}_e{nb}" for form in ("two", "pdl")
        for lanes in (4, 8, 16) for nb in (4, 8)} \
        == set(names) - {"earlier"}
    assert fused_gcn_designs.CASES == (("cora", 7), ("pubmed_rcm", 3))
    assert fused_gcn_designs.RATES == (0.0, 0.5)
    library = (_build.SOURCE_DIR / "fused_gcn.cu").read_text()
    assert '#include "row_lanes.cuh"' in library
    # lanes a row, edges a lane and the programmatic launch are constants
    assert "with_shape<kBwd, kBatch>(\n      p, kLanes," in library
    assert "cfg.numAttrs = 1;" in library
    # both walks are the CSR SpMM's row walk
    assert library.count("sum_row<L, V, NB>(") == 1
    spmm = (_build.SOURCE_DIR / "spmm_csr.cu").read_text()
    assert spmm.count("sum_row<L, V, NB>(") == 1
    # the library's two launches, the second programmatic: it loads its
    # CSR before it waits for the first's writes
    assert "this_grid" not in library
    second = library[library.index("fused_gcn_second_kernel(Params p"):]
    assert second.index("second_start<L, NB>(p)") \
        < second.index('asm volatile("griddepcontrol.wait;"')
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in library
    # the probe's cooperative form: one barrier between the walks
    coop = source[source.index("fused_gcn_coop_kernel(Params p) {"):]
    coop = coop[:coop.index("\n}\n")]
    assert coop.count("cg::this_grid().sync();") == 1
    assert coop.index("second_start<L, NB>(p)") \
        < coop.index("first_walk<kBwd, L, V, NB>(p)")


def test_bsr_gat_designs_times_the_library_beside_its_first_design():
    """The design probe includes the production source (so the shipped
    design is the library's own code, and the staged variant runs the
    library's row function) and launches the first design of all three
    kernels with the library's signatures: its forward and column pass
    copied into its own namespace, its row pass the library's, which
    keeps it for one head and the widths its lane map does not cover. Its
    library name hashes ``csrc/bsr_gat.cu`` and the headers it includes,
    and its cases cover the graphs and widths the main path and the slow
    spots use."""
    source = bsr_gat_designs.SOURCE.read_text()
    assert '#include "../pytorch_geometric_tpu_torch/csrc/bsr_gat.cu"' \
        in source
    assert "namespace first_design {" in source
    for kernel in ("bsr_fwd_kernel<KC>", "bsr_bwd_col_kernel<KC>"):
        assert f"first_design::{kernel}" in source
    assert "return launch_row_heads(" in source
    library = (_build.SOURCE_DIR / "bsr_gat.cu").read_text()
    assert "bsr_bwd_row_heads_kernel<KC><<<" in library
    assert "if (H == 1 || L % H != 0 || C > 32) return;" in library
    assert [p.name for p in _build._included(bsr_gat_designs.SOURCE)] == [
        "bsr_gat_designs.cu", "bsr_gat.cu", "row_lanes.cuh",
        "gat_mask.cuh"]
    sig = _build.SIGNATURES["bsr_gat"]
    for kernel in bsr_gat_designs.KERNELS:
        assert bsr_gat_designs.SIGNATURES[f"first_bsr_gat_{kernel}"] \
            == sig[f"bsr_gat_{kernel}"]
    assert bsr_gat_designs.SIGNATURES["staged_bsr_gat_fwd"] \
        == sig["bsr_gat_fwd"]
    assert "fwd_row<L, V>(src, i, a," in source
    assert ("pubmed_rcm", 8, 8, 0.6) in bsr_gat_designs.CASES
    assert {c[0] for c in bsr_gat_designs.CASES} == {
        "pubmed_rcm", "cora", "hub5003", "blocks16384"}


def test_packed_gat_designs_times_the_library_beside_its_first_design():
    """The packed-GAT design probe builds through ``build_source`` from a
    source that includes the production one (so the library's designs are
    its own code), keeps the first design's forward, which the library no
    longer launches, in a namespace of its own, launches the first design
    and the wide-head map of the forward and of the backward with the
    library's signatures, and covers the main path's graphs and widths,
    the hub graph (with (3, 5), where the backward keeps its first design
    and the forward's row map leaves lanes idle), PPI's train graph and
    val batch at (4, 256) and (6, 121), the research driver's (8, 135) and
    (8, 102), and dropout 0 and 0.6."""
    source = packed_gat_designs.SOURCE.read_text()
    text = Path(packed_gat_designs.__file__).read_text()
    assert "build_source(SOURCE, SIGNATURES)" in text
    assert '#include "../pytorch_geometric_tpu_torch/csrc/packed_gat.cu"' \
        in source
    assert "launch_bwd_heads(" in source
    assert "return first_design::launch_fwd_first(" in source
    assert "namespace first_design {" in source
    assert "gat_fwd_kernel<G><<<" in source
    assert "return launch_fwd_wide(" in source
    assert "return launch_bwd_wide(" in source
    library = (_build.SOURCE_DIR / "packed_gat.cu").read_text()
    assert "gat_bwd_heads_kernel<G, true>" in library
    assert "rc = launch_bwd<decltype(l)::value" in library
    assert "gat_fwd_kernel" not in library.split("// Plain C interface")[1]
    assert ": launch_fwd_wide(f, st);" in library
    assert "? launch_bwd_wide(a, src_side, st)" in library
    assert "gat_fwd_rows_kernel<L, decltype(v)::value" in library
    assert [p.name for p in _build._included(packed_gat_designs.SOURCE)] \
        == ["packed_gat_designs.cu", "packed_gat.cu", "row_lanes.cuh"]
    for kernel in ("fwd", "bwd"):
        for design in ("first", "wide"):
            assert packed_gat_designs.SIGNATURES[
                f"{design}_packed_gat_{kernel}"] \
                == _build.SIGNATURES["packed_gat"][f"packed_gat_{kernel}"]
    assert packed_gat_designs.DESIGNS == ("first", "shipped", "wide")
    cases = packed_gat_designs.CASES
    assert {c[0] for c in cases} == set(packed_gat_designs.GRAPHS) == {
        "cora", "pubmed_rcm", "hub", "ppi_train", "ppi_val", "cora_driver"}
    assert {c[3] for c in cases} == {0.0, 0.6}
    assert {("cora", 8, 8, 0.0), ("cora", 8, 8, 0.6), ("cora", 1, 7, 0.6),
            ("pubmed_rcm", 8, 8, 0.6), ("pubmed_rcm", 1, 3, 0.6),
            ("hub", 8, 8, 0.6), ("hub", 1, 7, 0.6),
            ("hub", 3, 5, 0.6)} <= set(cases)
    assert {(graph, H, C, rate)
            for graph in ("ppi_train", "ppi_val")
            for H, C in ((4, 256), (6, 121)) for rate in (0.0, 0.6)} \
        <= set(cases)
    assert {("cora_driver", H, C, rate) for H, C in ((8, 135), (8, 102))
            for rate in (0.0, 0.6)} <= set(cases)
    for design in ("lanes8", "row"):
        with pytest.raises(ValueError, match="unknown forward design"):
            packed_gat_designs.fwd_entry(None, design)
        with pytest.raises(ValueError, match="unknown backward design"):
            packed_gat_designs.entry(None, design)


def test_spmm_csr_designs_times_the_library_beside_its_first_design():
    """The SpMM design probe builds through ``build_source`` from a source
    that includes the production one (so every design is the library's
    own code, and the lanes and chunks variants its own row map and chunk
    map), launches the first design with the library's signature and the
    row map with the lanes, the chunk map with K, before the stream, times
    the launch floor and cuSPARSE, and covers Cora at F = 16, the class
    width, 33, 128, 300 and 1433, RCM-PubMed at 16, 3 and 128, the hub
    graph at 16 and Spline's two kernel-index CSRs at 1433; it times the
    lanes variants only where the row map takes F (at most 32 slots of
    one channel, or of four where F is a multiple of 4 and x aligned),
    and the chunk map from 32 channels at each K that holds at most 16
    channels a lane."""
    import torch

    source = spmm_csr_designs.SOURCE.read_text()
    text = Path(spmm_csr_designs.__file__).read_text()
    assert "build_source(SOURCE, SIGNATURES)" in text
    assert "floor_line(" in text and "torch.sparse.mm(" in text
    assert '#include "../pytorch_geometric_tpu_torch/csrc/spmm_csr.cu"' \
        in source
    assert "dispatch_first(" in source and "dispatch_rows(" in source
    assert "dispatch_chunks(" in source
    library = (_build.SOURCE_DIR / "spmm_csr.cu").read_text()
    assert "spmm_csr_kernel<T, G><<<" in library
    assert "spmm_csr_rows_kernel<T, kL, P, V>" in library
    assert "spmm_csr_chunks_kernel<T, V, K>" in library
    assert [p.name for p in _build._included(spmm_csr_designs.SOURCE)] \
        == ["spmm_csr_designs.cu", "spmm_csr.cu", "row_lanes.cuh"]
    sig = _build.SIGNATURES["spmm_csr"]["spmm_csr"]
    assert spmm_csr_designs.SIGNATURES["first_spmm_csr"] == sig
    for entry in ("lanes_spmm_csr", "chunks_spmm_csr"):
        extra = spmm_csr_designs.SIGNATURES[entry]
        assert extra[1] == sig[1][:-1] + [sig[1][-2], sig[1][-1]]
    assert set(spmm_csr_designs.CASES) == {
        ("cora", 16), ("cora", 7), ("cora", 128), ("cora", 33),
        ("cora", 300), ("cora", 1433), ("pubmed_rcm", 16),
        ("pubmed_rcm", 3), ("pubmed_rcm", 128), ("hub", 16),
        ("spline_k0", 1433), ("spline_k1", 1433)}
    assert spmm_csr_designs.LANES == (16, 32)
    assert spmm_csr_designs.CHUNK_K == (1, 2, 4, 8, 16)
    x = torch.zeros(8, 1434)
    for f, aligned, takes, chunks in (
            (16, True, True, ()), (128, True, True, (1, 2, 4)),
            (33, True, False, (1, 2, 4, 8, 16)),
            (32, True, True, (1, 2, 4)),
            (32, False, True, (1, 2, 4, 8, 16)),
            (36, False, False, (1, 2, 4, 8, 16)),
            (128, False, False, (1, 2, 4, 8, 16)),
            (1433, True, False, (1, 2, 4, 8, 16)),
            (300, True, False, (1, 2, 4))):
        xf = x.view(-1)[(0 if aligned else 1):][:8 * f].view(8, f)
        assert spmm_csr_designs.takes_row_map(f, xf) == takes, (f, aligned)
        names = spmm_csr_designs.designs(f, xf)
        assert names[:2] == ("first", "shipped")
        lanes = ("lanes16", "lanes32") if takes else ()
        assert names[2:] == lanes + tuple(f"chunks{k}" for k in chunks), \
            (f, aligned)
    with pytest.raises(ValueError, match="unknown design"):
        spmm_csr_designs.spmm(None, "rows", None, None, x)


def test_segment_sum_designs_times_the_library_beside_its_first_design():
    """The segment-sum design probe builds through ``build_source`` from a
    source that includes the sorted GCN's (so both designs are the shared
    header's own code), launches the first design with the library's
    signature and the chunk map with K before the stream, times the
    launch floor and ``torch.segment_reduce``, and covers the sorted GCN's
    RCM-PubMed CSRs at F = 16 and 3, the RGCN message sums at C = 16, 2
    and the hub operator's 33, AGNN's F = 1 and 16 and DNA's 128 by
    receiver and 256 to 1024 by sender; it times the chunk map at each K
    that holds at most 8 elements a lane."""
    import torch

    source = segment_sum_designs.SOURCE.read_text()
    text = Path(segment_sum_designs.__file__).read_text()
    assert "build_source(SOURCE, SIGNATURES)" in text
    assert "floor_line(" in text and "torch.segment_reduce(" in text
    assert '#include "../pytorch_geometric_tpu_torch/csrc/sorted_spmm.cu"' \
        in source
    assert "segment_sum::launch_design(" in source
    header = (_build.SOURCE_DIR / "segment_sum.cuh").read_text()
    assert "sorted_segment_sum_kernel<T, VEC, G>" in header
    assert "segment_sum_chunks_kernel<T, VEC, K>" in header
    assert [p.name for p in _build._included(segment_sum_designs.SOURCE)] \
        == ["segment_sum_designs.cu", "sorted_spmm.cu", "segment_sum.cuh"]
    sig = _build.SIGNATURES["sorted_spmm"]["sorted_segment_sum"]
    assert segment_sum_designs.SIGNATURES["first_segment_sum"] == sig
    chunks = segment_sum_designs.SIGNATURES["chunks_segment_sum"]
    assert chunks[1] == sig[1][:-1] + [sig[1][-2], sig[1][-1]]
    assert set(segment_sum_designs.CASES) == {
        ("pubmed_rcm", "fwd", 16), ("pubmed_rcm", "bwd", 16),
        ("pubmed_rcm", "fwd", 3), ("pubmed_rcm", "bwd", 3),
        ("mutag", "fwd", 16), ("mutag", "fwd", 2), ("rgcn_hub", "fwd", 33),
        ("agnn", "fwd", 1), ("agnn", "fwd", 16), ("agnn", "bwd", 16),
        ("dna", "fwd", 128), ("dna", "bwd", 256), ("dna", "bwd", 512),
        ("dna", "bwd", 768), ("dna", "bwd", 1024)}
    m = torch.zeros(8 * 1025)
    for f, dtype, offset, vec, ks in (
            (1024, torch.float32, 0, 4, (1, 2)),
            (1024, torch.float32, 1, 1, (1, 2, 4)),
            (1024, torch.bfloat16, 0, 8, (1,)),
            (33, torch.float32, 0, 1, (1, 2, 4)),
            (16, torch.bfloat16, 0, 8, (1,))):
        msgs = m.to(dtype)[offset:][:8 * f].view(8, f)
        assert segment_sum_designs.vec_of(f, msgs) == vec, (f, dtype)
        assert segment_sum_designs.designs(f, msgs) == ("first", "shipped") \
            + tuple(f"chunks{k}" for k in ks)
    with pytest.raises(ValueError, match="unknown design"):
        segment_sum_designs.segment_sum(None, "chunks8", None, m[:8, None])


def test_gat_hub_edges_hold_their_hubs_and_loops():
    """The packed-GAT hub graph that the card tests, the design probe and
    ``chip_smoke.py`` share: unique receiver-major pairs, a self loop on
    every node, row 3 with over 500 senders, node 10 sending to over 400
    receivers, nodes n-40 and up receiving only their loop; one graph for
    one seed."""
    s, r = graphs.gat_hub_edges()
    n = 512
    key = r * n + s
    assert (np.diff(key) > 0).all()
    assert set(key[s == r] % n) == set(range(n))
    assert np.bincount(r, minlength=n)[3] >= 500
    assert np.bincount(s, minlength=n)[10] >= 400
    assert (np.bincount(r, minlength=n)[n - 40:] == 1).all()
    assert all(np.array_equal(a, b)
               for a, b in zip(graphs.gat_hub_edges(), (s, r)))
    assert not np.array_equal(graphs.gat_hub_edges(seed=9)[0], s)


def test_spmm_hub_operator_is_the_gat_hub_graph_with_seeded_weights():
    """The SpMM hub graph that ``chip_smoke.py``, the design probe and the
    card tests share: the packed-GAT hub edges as an ``SpmmOperator``
    (a receiver row of 501 edges, a sender row of 402), fp32 weights in
    edge order, one set of weights for one seed; routed into both CSR
    orders, each row's weights are its edges'."""
    import torch

    op, w = graphs.spmm_hub_operator("cpu", 0)
    s, r = graphs.gat_hub_edges()
    assert w.dtype == np.float32 and w.shape == s.shape
    rows = (op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]).numpy()
    cols = (op.bwd.row_ptr[1:] - op.bwd.row_ptr[:-1]).numpy()
    assert (rows.max(), rows[3], cols.max(), cols[10]) == (501, 501, 402, 402)
    np.testing.assert_array_equal(rows, np.bincount(r, minlength=512))
    val_f, val_b = op.route_weights(w)
    np.testing.assert_array_equal(val_f.numpy(), w[op.fwd.perm.numpy()])
    np.testing.assert_array_equal(val_b.numpy(), w[op.bwd.perm.numpy()])
    np.testing.assert_array_equal(graphs.spmm_hub_operator("cpu", 0)[1], w)
    assert not np.array_equal(graphs.spmm_hub_operator("cpu", 1)[1], w)
    assert isinstance(val_f, torch.Tensor)


def test_bsr_synthetic_masks_hold_their_hub_lines_and_empty_lines():
    """The masks the bsr kernel cases and the design probe share: the
    block-dense one above the dense operator's cap with its empty rows and
    columns, the hub one with a row and a column of over 2,000 distinct
    entries."""
    (dense, s, r, n, heads, _), (hub, hs, hr, m, hub_heads, _) = \
        graphs.bsr_synthetic_masks(0)
    assert (dense, n, heads) == ("blocks16384", 16384, ((8, 8),))
    assert not np.isin(r, np.arange(100, 140)).any()
    assert not np.isin(s, np.arange(300, 350)).any()
    assert len(np.unique(r * n + s)) > 1_000_000
    assert (hub, m) == ("hub5003", 5003) and (3, 5) in hub_heads
    key = np.unique(hr * m + hs)
    assert np.bincount(key // m).argmax() == 3
    assert np.bincount(key % m).argmax() == 10
    assert min(np.bincount(key // m).max(),
               np.bincount(key % m).max()) > 2000
    assert all(np.array_equal(a, b) for a, b in zip(
        graphs.bsr_synthetic_masks(0)[1][1:3], (hs, hr)))


@pytest.mark.parametrize("variant", sorted(bsr_gat_variants.VARIANTS))
def test_each_bsr_variant_edits_the_source_once(variant):
    """Every variant of ``probes/bsr_gat_variants.py`` undoes one choice
    of the current ``csrc/bsr_gat.cu``: its anchors occur exactly once
    there, and the edit changes the source."""
    _, edits = bsr_gat_variants.VARIANTS[variant]
    source = bsr_gat_variants.LIBRARY.read_text()
    assert bsr_gat_variants.variant_source(edits) != source


def test_bsr_phase_clocks_mark_every_phase_of_both_kernels():
    """The phase clocks' edits apply to the current source: five reads in
    the forward's row function and five in the fused column pass, and the
    entry point that copies them out."""
    source = bsr_gat_variants.variant_source(
        bsr_gat_variants._PHASES + [bsr_gat_variants._CLOCK_READ],
        bsr_gat_variants._CLOCK_HEAD)
    for k in range(5):
        assert source.count(f"CLOCK(i, {k},") == 1
        assert source.count(f"CLOCK(j, {k},") == 1
    assert 'extern "C" int bsr_clock_read(' in source
    with pytest.raises(ValueError, match="anchor"):
        bsr_gat_variants.variant_source([("no such text", "")])


@pytest.mark.parametrize("variant", sorted(packed_gat_variants.VARIANTS))
def test_each_packed_gat_variant_edits_the_source_once(variant):
    """Every variant of ``probes/packed_gat_variants.py`` undoes one
    choice of the current ``csrc/packed_gat.cu``: each of its anchors
    occurs exactly once there, and the edit changes the source."""
    _, edits = packed_gat_variants.VARIANTS[variant]
    source = packed_gat_variants.LIBRARY.read_text()
    for old, _ in edits:
        assert source.count(old) == 1, old
    assert packed_gat_variants.variant_source(edits) != source


@pytest.mark.parametrize("variant", sorted(chunk_map_variants.VARIANTS))
def test_each_chunk_map_variant_edits_its_kernel_once(variant):
    """Every variant of ``probes/chunk_map_variants.py`` changes one choice
    of the current chunk map of ``csrc/spmm_csr.cu`` (``spmm_*``) or of
    ``csrc/segment_sum.cuh`` (``seg_*``): each of its anchors occurs
    exactly once in the kernel's source, the edit changes it, and the
    variant keeps its library's entry point and the design probes'
    cases."""
    kernel = chunk_map_variants.kernel_of(variant)
    library, edited = chunk_map_variants.SOURCES[kernel]
    _, edits = chunk_map_variants.VARIANTS[variant]
    source = edited.read_text()
    chunk_map = source[source.index("// The chunk map (see the head") - 200:]
    for old, _ in edits:
        assert source.count(old) == 1 and old in chunk_map, old
    assert chunk_map_variants.common.variant_source(edited, edits) != source
    assert f'#include "{edited.name}"' in library.read_text() \
        or edited == library
    name = chunk_map_variants.LIBRARIES[kernel]
    assert chunk_map_variants.SIGNATURES[kernel] == _build.SIGNATURES[name]
    probe = {"spmm": spmm_csr_designs, "seg": segment_sum_designs}[kernel]
    for k, graph, direction, f in chunk_map_variants.CASES:
        if k == "spmm" == kernel:
            assert (graph, f) in probe.CASES
        elif k == "seg" == kernel:
            assert (graph, direction, f) in probe.CASES


def test_packed_gat_phase_clocks_mark_every_phase_of_the_backward():
    """The phase clocks' edits apply to the current source: four reads in
    the sub-warp backward, the steps of its walk, and the entry point that
    copies them out, after the source's first include."""
    edits, signatures, head = packed_gat_variants.PHASES
    source = packed_gat_variants.variant_source(edits, head)
    for k in range(4):
        assert source.count(f"CLOCK(r, {k},") == 1
    assert "gat_clock[r * 5 + 4] =" in source
    assert source.index('#include "row_lanes.cuh"') \
        < source.index('extern "C" int gat_clock_read(')
    assert list(signatures) == ["gat_clock_read"]


_C_TYPES = {"int": "c_int", "unsigned": "c_uint", "float": "c_float"}


def _c_entry_points(source: str):
    """{name: [ctypes name of each parameter]} of the ``extern "C"``
    functions of a CUDA source: pointers (``void*``, ``int*``) as
    ``c_void_p`` or a ctypes pointer, the scalars by their type."""
    found = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)\s*\{', source):
        kinds = []
        for param in params.split(","):
            ctype = param.split()[0] if param.strip() else None
            kinds.append("pointer" if "*" in param else _C_TYPES[ctype])
        found[name] = kinds
    return found


def _ctypes_kind(t):
    import ctypes

    if t is ctypes.c_void_p or (isinstance(t, type)
                                and issubclass(t, ctypes._Pointer)):
        return "pointer"
    return t.__name__


@pytest.mark.parametrize("module", [
    "library", "gat_ablate", "rgcn_ablate", "bsr_gat_designs",
    "packed_gat_designs", "flash_gat_designs", "packed_rgcn_designs",
    "spmm_csr_designs", "segment_sum_designs", "fused_gcn_designs"])
def test_every_loader_signature_is_its_sources_entry_point(module):
    """Each ctypes signature that a loader declares (the library's per
    source, each probe's) names an ``extern "C"`` function of the source
    it loads, with as many parameters of the same kinds, so a loader
    never calls a changed entry point with its old arguments (the
    two-launch ``packed_rgcn_fwd``, the probes' ``first_packed_rgcn_fwd``
    and ``first_flash_gat_fwd`` among them)."""
    if module == "library":
        pairs = [(_build.SOURCE_DIR / f"{name}.cu", sigs)
                 for name, sigs in _build.SIGNATURES.items()]
    else:
        probe = globals()[module]
        pairs = [(probe.SOURCE, probe.SIGNATURES)]
    for path, sigs in pairs:
        entries = _c_entry_points(path.read_text())
        for fn, (restype, argtypes) in sigs.items():
            assert fn in entries, (path.name, fn)
            assert restype.__name__ == "c_int"
            assert [_ctypes_kind(t) for t in argtypes] == entries[fn], fn
