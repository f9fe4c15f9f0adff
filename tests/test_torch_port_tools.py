"""The port's tool scripts (``pytorch_geometric_tpu_torch/tools/``) on the
CPU, against the JAX package's ``tools/`` scripts.

- Each script's ``main`` at a tiny size with ``--device cpu`` (one point):
  the records it returns are the JSON lines it prints, their times are
  the host's (``*_host_us``, never a device name) and each carries its
  operator's check against the plain version.
- The generators draw for draw: ``tools/probe_reddit.py:gen_clustered``,
  and the inline draws of ``tools/adv_asym_probe.py`` and
  ``tools/sparse_tail_probe.py``, captured from their ``main`` with the
  JAX operator and timer replaced by stubs that record their arguments
  (the scripts are loaded by path and left as they are).
- ``gat_sweep`` and ``rgcn_sweep``'s graphs against the JAX scripts'
  ``build_graph`` on Cora and MUTAG-RDF (at scale 0.01: the JAX
  ``Entities`` is replaced by one at that scale), each JAX dataset under
  a temporary working directory with its ``SYNTHETIC`` marker.
- ``gen_api_docs`` from another working directory: its ``--out`` names
  every name of the port's ``__all__`` surfaces.
- The two contraction sweeps: the repository's grids, the port's driver.
"""

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import pytorch_geometric_tpu.datasets as jdatasets
from pytorch_geometric_tpu_torch.datasets import graphs
from pytorch_geometric_tpu_torch.tools import (
    adv_asym_probe, gat_sweep, gen_api_docs, probe_reddit, profile_epoch,
    reddit_threshold_probe, rgcn_sweep, sparse_tail_probe)

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "pytorch_geometric_tpu_torch" / "tools"
TINY = ["--n", "2048", "--e", "20000", "--f", "16", "--device", "cpu"]


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool,argv,check_keys", [
    (gat_sweep, ["--dataset", "Cora", "--device", "cpu"],
     ("fwd_err", "bwd_err", "fwd_host_us", "fwd_bwd_host_us",
      "fwd_bound_us")),
    (rgcn_sweep, ["--scale", "0.01", "--epoch", "--device", "cpu"],
     ("fwd_err", "bwd_err", "fwd_host_us", "fwd_bwd_host_us")),
    (profile_epoch, ["--which", "rgcn_mutag", "--scale", "0.01",
                     "--epochs", "2", "--reps", "1", "--top", "3",
                     "--device", "cpu"],
     ("host_busy_ms_per_epoch", "host_idle_share", "top")),
    (probe_reddit, TINY, ("gen_s", "build_s", "upload_s", "fwd_err",
                          "fwd_host_us", "fwd_bwd_host_us")),
    (probe_reddit, TINY + ["--block", "--window", "256",
                           "--dense-threshold", "64", "--skip-bwd"],
     ("build_s", "dense_blocks", "remainder_edges", "fwd_err",
      "fwd_host_us")),
    (sparse_tail_probe, TINY, ("fwd_err", "fwd_host_ns_per_edge",
                               "bound_us")),
    (reddit_threshold_probe, TINY + ["--thresholds", "64"],
     ("bucket_histogram",)),
    (adv_asym_probe, TINY + ["--windows", "256"],
     ("fwd_err", "fwd_host_ns_per_edge", "dense_blocks",
      "remainder_edges"))],
    ids=["gat_sweep", "rgcn_sweep", "profile_epoch", "probe_reddit",
         "probe_reddit_block", "sparse_tail_probe",
         "reddit_threshold_probe", "adv_asym_probe"])
def test_tool_main_on_the_cpu_prints_its_records(tool, argv, check_keys,
                                                  capsys):
    records = tool.main(argv)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert records and printed == records
    assert set(check_keys) <= set(records[0]) | set(records[-1])
    for rec in records:
        assert rec["device"] == "cpu"
        assert not any("device_us" in k or k.startswith("device_")
                       for k in rec)
        for key, value in rec.items():
            if key.endswith("_err"):
                assert value <= 1e-2, (key, value)


def test_reddit_generator_is_the_jax_scripts_draw_for_draw():
    want = _jax_tool("probe_reddit").gen_clustered(2048, 20_000, 200)
    got = graphs.gen_clustered(2048, 20_000, 200)[:2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


class _Drawn(Exception):
    """Raised by the stubs once the JAX script has drawn everything."""


def _record_draws_for(monkeypatch, module, name):
    """Stub the JAX operator ``module.name`` to record its edge arguments,
    and ``bench_common.time_program`` to record x and stop the script."""
    seen = {}

    class Stub:
        def __init__(self, senders, receivers, n, w=None, **kw):
            seen.update(senders=np.asarray(senders),
                        receivers=np.asarray(receivers))
            if w is not None:
                seen["w"] = np.asarray(w)

        def bind_external(self, w):
            seen["w"] = np.asarray(w)
            return None, {}

        def bind(self):
            return None, {}

    def time_program(run, consts, x, **kw):
        seen["x"] = np.asarray(x)
        raise _Drawn

    monkeypatch.setattr(module, name, Stub)
    if str(REPO) not in sys.path:
        monkeypatch.syspath_prepend(str(REPO))
    import bench_common

    monkeypatch.setattr(bench_common, "time_program", time_program)
    return seen


def test_sparse_tail_draws_are_the_jax_scripts(monkeypatch):
    seen = _record_draws_for(monkeypatch, importlib.import_module(
        "pytorch_geometric_tpu.ops.spmm"), "SpmmOperator")
    jax_main = _jax_tool("sparse_tail_probe").main
    monkeypatch.setattr(sys, "argv", ["x", "--n", "2048", "--e", "20000",
                                      "--f", "16", "--points", "1024:256"])
    with pytest.raises(_Drawn):
        jax_main()
    rng, senders, receivers, w = sparse_tail_probe.draw_edges(2048, 20_000)
    x = rng.normal(size=(2048, 16)).astype(np.float32)
    for key, got in (("senders", senders), ("receivers", receivers),
                     ("w", w), ("x", x)):
        np.testing.assert_array_equal(got, seen[key], err_msg=key)


def test_adv_asym_draws_are_the_jax_scripts(monkeypatch):
    seen = _record_draws_for(monkeypatch, importlib.import_module(
        "pytorch_geometric_tpu.ops.block_spmm"), "BlockSpmm")
    jax_main = _jax_tool("adv_asym_probe").main
    monkeypatch.setattr(sys, "argv", ["x", "--n", "2048", "--e", "20000",
                                      "--f", "16", "--points",
                                      "1024:1024:128"])
    with pytest.raises(_Drawn):
        jax_main()
    senders, receivers, w, x = adv_asym_probe.draw(2048, 20_000, 16)
    for key, got in (("senders", senders), ("receivers", receivers),
                     ("w", w), ("x", x)):
        np.testing.assert_array_equal(got, seen[key], err_msg=key)


def _marker(raw):
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")


def test_gat_sweep_graph_is_the_jax_build_graph(tmp_path, monkeypatch):
    _marker(tmp_path / "datasets_cache" / "Cora" / "raw")
    monkeypatch.chdir(tmp_path)
    want = _jax_tool("gat_sweep").build_graph("Cora")
    got = gat_sweep.build_graph("Cora", "cpu")
    for key in ("senders", "receivers", "x", "y"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)


def test_rgcn_sweep_graph_is_the_jax_build_graph(tmp_path, monkeypatch):
    _marker(tmp_path / "datasets_cache_fullmutag" / "entities" / "mutag"
            / "raw")
    monkeypatch.chdir(tmp_path)
    j_entities = jdatasets.Entities
    monkeypatch.setattr(jdatasets, "Entities",
                        lambda root, name, scale: j_entities(root, name,
                                                             scale=0.01))
    want, want_data = _jax_tool("rgcn_sweep").build_graph()
    got, data = rgcn_sweep.build_graph(0.01, "cpu")
    for key in ("senders", "receivers", "y"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)
    for key in ("train_idx", "test_idx", "edge_type"):
        np.testing.assert_array_equal(np.asarray(data[key]),
                                      np.asarray(want_data[key]),
                                      err_msg=key)


def test_gen_api_docs_is_anchored_to_the_package(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = gen_api_docs.main(["--out", str(tmp_path / "api.md")])
    text = out.read_text()
    assert out == tmp_path / "api.md" and not (tmp_path / "docs").exists()
    for name, _ in gen_api_docs.MODULES:
        mod = importlib.import_module(name)
        assert f"## `{name}`" in text
        for n in getattr(mod, "__all__", []):
            assert re.search(r"\| `%s[(`]" % re.escape(n), text), (name, n)
    for sub in ("research", "ops", "tools"):
        for p in (TOOLS.parent / sub).glob("*.py"):
            if p.stem != "__init__":
                assert f"`{sub}.{p.stem}`" in text
    assert gen_api_docs.OUT == REPO / "docs" / "API_torch.md"


def _grid(script: Path):
    """The script's lines that set its grid, its loops and its driver's
    flags, the module name and DEVICES's default left out."""
    keep = []
    for ln in script.read_text().splitlines():
        ln = ln.strip()
        if ln.startswith("#") or not ln or ln.startswith("DEVICES="):
            continue
        keep.append(ln.replace("pytorch_geometric_tpu_torch.research",
                               "pytorch_geometric_tpu.research"))
    return keep


@pytest.mark.parametrize("name", ["run_contraction_sweep.sh",
                                  "run_contraction_sweep_dp.sh"])
def test_contraction_sweeps_keep_the_grids_and_call_the_port(name):
    port = (TOOLS / name).read_text()
    assert "python -m pytorch_geometric_tpu_torch.research.driver" in port
    assert "python -m pytorch_geometric_tpu.research" not in port
    assert _grid(TOOLS / name) == _grid(REPO / name)
    if name.endswith("_dp.sh"):
        assert 'DEVICES="${DEVICES:-1}"' in port
