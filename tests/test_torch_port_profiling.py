"""Port parity, ``profiling.py`` and ``debug.py``: the port's modules
against the JAX package's on the same numpy inputs. Roofline numbers
equal given the same peaks, ``nan_guard`` raises on the same outputs,
singular values within 1e-5 of the largest (another SVD), the same
``.npy`` history, the same debug flag and the index checks it gates. The
timers: ``time_fn`` runs on the CPU, ``device_ms`` refuses to run
without a card."""

import importlib

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu import profiling as jprof
from pytorch_geometric_tpu_torch import debug, profiling

# the JAX package's __init__ exports the function debug() under the
# module's name
jdebug = importlib.import_module("pytorch_geometric_tpu.debug")

PEAKS = [{}, {"hbm_gbps": 819.0, "peak_tflops": 197.0},
         {"hbm_gbps": 3350.0, "dtype_bytes": 2}]


@pytest.mark.parametrize("extra", PEAKS)
def test_kernel_stats_match_jax(extra):
    """bytes, flops, HBM fraction and edges per second agree given the
    same peaks (the port's defaults are the H100 SXM's)."""
    shape = dict(num_edges=113_216, num_nodes=24_576, feature_dim=16,
                 elapsed_s=3.75e-6)
    port = profiling.KernelStats(**shape, **extra)
    want = jprof.KernelStats(**shape, **{"hbm_gbps": port.hbm_gbps,
                                         "peak_tflops": port.peak_tflops,
                                         **extra})
    assert port.bytes_moved == want.bytes_moved
    assert port.flops == want.flops
    assert port.hbm_fraction() == want.hbm_fraction()
    assert port.edges_per_sec() == want.edges_per_sec()
    assert profiling.KernelStats(1, 1, 1).hbm_gbps == 3350.0


def test_kernel_stats_without_a_time_give_none():
    for cls in (profiling.KernelStats, jprof.KernelStats):
        stats = cls(num_edges=10, num_nodes=5, feature_dim=3)
        assert stats.hbm_fraction() is None and stats.edges_per_sec() is None


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, None])
def test_nan_guard_raises_on_the_same_outputs(bad):
    """A non-finite float anywhere in the outputs (a tuple holding a dict)
    raises FloatingPointError on both; finite or integer outputs pass."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    if bad is not None:
        x[1, 2] = bad
    ints = np.arange(4)

    def jfn(a):
        return a, {"ints": ints, "x": a * 2}

    def fn(a):
        return torch.from_numpy(a), {"ints": torch.from_numpy(ints),
                                     "x": torch.from_numpy(a) * 2}

    outcomes = []
    for guarded in (jprof.nan_guard(jfn), profiling.nan_guard(fn)):
        try:
            guarded(x)
            outcomes.append("ok")
        except FloatingPointError as exc:
            assert "non-finite output" in str(exc)
            outcomes.append("raised")
    assert outcomes[0] == outcomes[1] == ("ok" if bad is None else "raised")


@pytest.mark.parametrize("shape,cutoff", [((40, 12), 10), ((7, 30), 3)])
def test_save_dynamics_evolution_matches_jax(tmp_path, shape, cutoff):
    rng = np.random.default_rng(7)
    mats = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    hist, jhist = None, None
    for x in mats:
        hist = profiling.save_dynamics_evolution(
            torch.from_numpy(x), str(tmp_path / "port.npy"), cutoff, hist)
        jhist = jprof.save_dynamics_evolution(
            x, str(tmp_path / "jax.npy"), cutoff, jhist)
    got = np.load(tmp_path / "port.npy", allow_pickle=True)
    want = np.load(tmp_path / "jax.npy", allow_pickle=True)
    assert got.shape == want.shape == (3, min(min(shape), cutoff))
    assert got.dtype == want.dtype == object
    g, w = got.astype(np.float64), want.astype(np.float64)
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    assert len(hist) == len(jhist) == 3


def test_debug_flag_and_context_manager_match_jax():
    for mod in (debug, jdebug):
        assert mod.is_debug_enabled() is False
        with mod.debug():
            assert mod.is_debug_enabled() is True
            with mod.debug():
                assert mod.is_debug_enabled() is True
            assert mod.is_debug_enabled() is True
        assert mod.is_debug_enabled() is False
        with pytest.raises(KeyError):
            with mod.debug():
                raise KeyError("inside")
        assert mod.is_debug_enabled() is False
        mod.set_debug(1)
        assert mod.is_debug_enabled() is True
        mod.set_debug(0)
        assert mod.is_debug_enabled() is False


def test_logging_is_gated_like_jax(capsys):
    for mod in (profiling, jprof):
        mod.logging("shown")
        mod.set_logging(False)
        mod.logging("hidden")
        mod.set_logging(True)
    assert capsys.readouterr().out == "shown\nshown\n"


def test_time_fn_on_the_cpu():
    calls = []

    def work(n):
        calls.append(n)
        return torch.ones(n).sum()

    best = profiling.time_fn(work, 1000, iters=4, warmup=2)
    assert 0 < best < 5
    assert calls == [1000] * 6


def test_device_ms_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for flush in (False, True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profiling.device_ms(lambda: ran.append(1), flush_l2=flush)
    assert ran == []


def test_print_device_usage_is_gated(capsys, monkeypatch):
    profiling.print_device_usage()
    assert capsys.readouterr().out == ""
    monkeypatch.setitem(profiling._FLAGS, "print_device_usage", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profiling.print_device_usage()
    assert capsys.readouterr().out == "no CUDA device\n"


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    with profiling.trace(str(tmp_path / "t")) as logdir:
        torch.ones(64).mul(2).sum()
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert logdir == str(tmp_path / "t")
    assert any("mul" in e.get("name", "") for e in trace["traceEvents"])


def test_bound_ms_takes_the_larger_time():
    ms, by = profiling.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = profiling.bound_ms(1.0, 67e9 * 2)
    assert ms == pytest.approx(2.0) and by == "operations"


@pytest.mark.parametrize("events,want", [
    # apart: each its own time
    ([(0.0, 2.0, "a"), (3.0, 4.0, "b")], {"a": (2.0, 1), "b": (1.0, 1)}),
    # a programmatic dependent launch that starts before its predecessor
    # ends: the common time counts once, for the first
    ([(2.0, 15.0, "fused_gcn_second"), (0.0, 10.0, "fused_gcn_first")],
     {"fused_gcn_first": (10.0, 1), "fused_gcn_second": (5.0, 1)}),
    # one inside another: no time of its own, one event
    ([(0.0, 10.0, "a"), (2.0, 5.0, "b"), (12.0, 13.0, "b")],
     {"a": (10.0, 1), "b": (1.0, 2)}),
])
def test_busy_by_name_counts_overlapping_events_once(events, want):
    """The device's busy time is the union of its events' intervals, so
    a trace's idle share and each group's µs do not count the time in
    which one kernel waits for another that still runs."""
    got = profiling.busy_by_name(events)
    assert got == want
    kernels = sorted(((us, name, n) for name, (us, n) in got.items()),
                     reverse=True)
    union = sum(us for us, _ in want.values())
    summary, port = profiling.trace_summary(kernels, 20.0, 1)
    assert summary["device_busy_ms_per_epoch"] == pytest.approx(union / 1e3)
    assert summary["device_idle_share"] == pytest.approx(1 - union / 20.0)
    assert port == sum(n for name, (_, n) in want.items()
                       if "fused_gcn" in name)


@pytest.mark.parametrize("bad", ["sender_negative", "receiver_past_end"])
def test_debug_flag_validates_gather_aggregate_edges_like_jax(bad):
    """Under the flag the port's gather-aggregate ``ops/spmm.py:spmm``
    refuses edge indices out of range before it gathers, as the JAX
    package's ``propagate`` does under its own; without it nothing is
    checked (a negative sender gathers from the end of ``x``, a receiver
    past the end fails inside torch's ``index_add_``), and valid edges
    give the same result either way."""
    import jax.numpy as jnp

    from pytorch_geometric_tpu.data.graph import Graph as JGraph
    from pytorch_geometric_tpu.nn.message_passing import propagate
    from pytorch_geometric_tpu_torch.ops.spmm import spmm

    n = 6
    x = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    s, r = np.array([0, 1, 2, 3, 4]), np.array([1, 2, 3, 4, 5])
    tx = torch.from_numpy(x)
    want = spmm(torch.from_numpy(s), torch.from_numpy(r), tx, n)
    with debug.debug():
        assert torch.equal(spmm(torch.from_numpy(s), torch.from_numpy(r),
                                tx, n), want)
    if bad == "sender_negative":
        s[2] = -1
    else:
        r[2] = n
    ts, tr = torch.from_numpy(s), torch.from_numpy(r)
    jg = JGraph(senders=jnp.asarray(s, jnp.int32),
                receivers=jnp.asarray(r, jnp.int32), x=jnp.asarray(x))
    with jdebug.debug(), pytest.raises(ValueError, match="out of range"):
        propagate(jg, jg.x)
    with debug.debug(), pytest.raises(ValueError, match="out of range"):
        spmm(ts, tr, tx, n)
    if bad == "sender_negative":
        out = spmm(ts, tr, tx, n)
        np.testing.assert_array_equal(out[3].numpy(), x[-1])
    else:
        with pytest.raises(RuntimeError):
            spmm(ts, tr, tx, n)
