"""Profiling and observability.

Counterpart of ``pytorch_geometric_tpu/profiling.py``, in PyTorch: gated
prints (``logging`` and its flag, reference ConvexPruning.py:143-148),
device memory use (``print_device_usage``, :150-155), activation
dynamics by singular-value snapshots (``save_dynamics_evolution``,
:98-104) in the same ``.npy`` history, a timeline trace (``trace``, on
``torch.profiler`` where the JAX module wraps ``jax.profiler``), roofline
numbers (``KernelStats``, with the H100 SXM's peaks), a best-of wall
timer (``time_fn``) and ``nan_guard``.

:func:`device_ms` is the port's device timer, the counterpart of the
K-scanned ``bench_common.time_program`` that the JAX package's probes
time with: ``calls`` calls captured in one CUDA graph and timed with CUDA
events, with the 50 MB L2 warm between calls or flushed before each.
``chip_smoke.py`` and the probes under ``probes/`` take it from here.

:func:`profile_steps` and :func:`trace_summary` read a ``torch.profiler``
window over a training step: the device's events by name against the
host's clock (each event's time not overlapped by an earlier one, so that
kernels that run at once, as a programmatic dependent launch waiting on
its predecessor, count once), its busy and idle shares and the port's
launches counted from the events (``chip_smoke.py``'s ``trace*`` phases and
``tools/profile_epoch.py``).
"""

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

_FLAGS = {"print_to_logging": True, "print_device_usage": False}

#: The H100's L2 cache; a flush writes twice this.
L2_BYTES = 50 * 2 ** 20
#: H100 SXM data-sheet peaks for a kernel's bound: device memory bytes/s,
#: fp32 (non-tensor-core) flop/s and dense bf16 tensor-core flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def set_logging(enabled: bool) -> None:
    _FLAGS["print_to_logging"] = enabled


def logging(message: str) -> None:
    """Gated print (reference ConvexPruning.py:143-148)."""
    if _FLAGS["print_to_logging"]:
        print(message)


def print_device_usage() -> None:
    """Device memory of each CUDA device, when its flag is on (the
    reference shells out to nvidia-smi, :150-155): what the card has in
    use and in all (``torch.cuda.mem_get_info``) and what this process's
    tensors hold (``torch.cuda.memory_allocated``)."""
    if not _FLAGS["print_device_usage"]:
        return
    if not torch.cuda.is_available():
        print("no CUDA device")
        return
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        mine = torch.cuda.memory_allocated(i)
        print(f"[cuda:{i} {torch.cuda.get_device_name(i)}] "
              f"{(total - free) / 2 ** 20:.0f} MiB / {total / 2 ** 20:.0f} "
              f"MiB in use, {mine / 2 ** 20:.0f} MiB by this process")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` timeline around a block (CPU, and the card's
    kernels where there is one), written as ``trace.json`` (Chrome trace
    format) into ``logdir`` (default: ``torch-trace`` in the temporary
    directory), which it yields."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class KernelStats:
    """Roofline accounting for a segment/SpMM launch."""

    num_edges: int
    num_nodes: int
    feature_dim: int
    dtype_bytes: int = 4
    elapsed_s: Optional[float] = None
    # per-card peaks: the H100 SXM data sheet (device memory, bf16 dense)
    hbm_gbps: float = 3350.0
    peak_tflops: float = 989.0

    @property
    def bytes_moved(self) -> int:
        """Min traffic: read one source row + weight per edge, write each
        output row once."""
        e, n, f, b = (self.num_edges, self.num_nodes, self.feature_dim,
                      self.dtype_bytes)
        return e * (f * b + 4 + 8) + n * f * b

    @property
    def flops(self) -> int:
        return 2 * self.num_edges * self.feature_dim

    def hbm_fraction(self) -> Optional[float]:
        if not self.elapsed_s:
            return None
        return (self.bytes_moved / self.elapsed_s) / (self.hbm_gbps * 1e9)

    def edges_per_sec(self) -> Optional[float]:
        if not self.elapsed_s:
            return None
        return self.num_edges / self.elapsed_s


def bound_ms(nbytes: float, flops: float):
    """``(ms, "bytes" or "operations")``: the least time this card could
    take to move ``nbytes`` and do ``flops`` fp32 operations, the larger
    of the two times, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best-of wall seconds of ``fn(*args)``: synchronised with the card
    where there is one (the work's end, not its enqueue), plain wall time
    on the CPU."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _leaves(out):
    if isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)
    elif out is not None:
        yield out


def nan_guard(fn):
    """Wrap fn to raise on non-finite outputs (tensors, arrays and
    numbers, also inside tuples, lists and dicts)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for leaf in _leaves(out):
            t = torch.as_tensor(leaf)
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"nan_guard: non-finite output from {fn.__name__}")
        return out

    return wrapped


def save_dynamics_evolution(x, path: str, num_cutoff: int = 10,
                            history: Optional[List] = None):
    """Singular values of an activation matrix appended to a .npy history
    (reference SaveDynamicsEvolution, ConvexPruning.py:98-104)."""
    d = torch.linalg.svdvals(torch.as_tensor(x).detach())
    history = history if history is not None else []
    history.append(d[:num_cutoff].cpu().numpy().tolist())
    np.save(path, np.asarray(history, dtype=object), allow_pickle=True)
    return history


def _graph_ms(body, calls):
    """Device ms of ``calls`` runs of ``body`` captured in one CUDA graph
    and replayed once (after one untimed replay)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            body()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, calls: int = 50, flush_l2: bool = False) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so host overhead between
    launches is not counted. Without ``flush_l2`` the inputs stay in the
    50 MB L2 between calls, as they do between the layers of a training
    step. With it, a write of twice the L2 runs before each call inside
    the graph, and the same number of writes alone is timed and
    subtracted, so each call starts from device memory. Raises where
    there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times CUDA graphs on the card, and "
                           "CUDA is not available")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if not flush_l2:
        return _graph_ms(fn, calls) / calls
    scrub = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        scrub.fill_(1)
        fn()

    total = _graph_ms(flushed, calls)
    return (total - _graph_ms(lambda: scrub.fill_(1), calls)) / calls


#: Cycles of the spin kernel that opens a trace's active window: about
#: 50 ms at the H100's 1.98 GHz boost clock.
SPIN_CYCLES = 100_000_000
#: Substrings of the port's kernel names on the profiler's device events.
PORT_KERNEL_NAMES = ("spmm_csr", "gat_fwd_", "gat_bwd_", "rgcn_",
                     "flash_fwd_", "flash_bwd_", "bsr_fwd_", "bsr_bwd_",
                     "sorted_segment_sum", "segment_sum_chunks",
                     "fused_gcn")


def busy_by_name(events):
    """``{name: (µs, events)}`` of device events ``(start_us, end_us,
    name)``: each event is credited with the part of its interval that no
    event starting before it covers, so that the sum over the names is the
    union of the intervals, the time the device was busy. Two kernels that
    overlap (a programmatic dependent launch starts before its predecessor
    ends and waits for it) count their common time once, for the one that
    started first."""
    per_name = {}
    covered = float("-inf")
    for start, end, name in sorted(events):
        us = max(0.0, end - max(start, covered))
        covered = max(covered, end)
        total, n = per_name.get(name, (0.0, 0))
        per_name[name] = (total + us, n + 1)
    return per_name


def profile_steps(run, steps, device="cuda"):
    """``torch.profiler`` over ``steps`` calls of ``run`` after five
    untraced and three traced warm-up calls: the events' µs by name
    (:func:`busy_by_name`: overlapping events count once, so the µs sum
    to the busy time), as ``[(us, name, calls)]`` largest first, and the
    host's wall-clock µs of the active window. On a card the events are
    the device's (kernels, memsets, copies); on the CPU
    (``device="cpu"``) the host operators' self times, so that nested
    operators count once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(5):
        run()
    sync()
    # The profiler traces the card from its warm-up steps on and records
    # only the active ones, each window closed by a synchronisation. It
    # drops the device events that it places before the active window's
    # start, and it has placed the first 10-90 events of the first epoch
    # there (a few ms of them): a spin kernel of SPIN_CYCLES opens the
    # window, and is left out of every count.
    warm = 3
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warm, active=steps,
                                   repeat=1)) as prof:
        for i in range(warm + steps):
            if i == warm:
                if cuda:
                    torch.cuda._sleep(SPIN_CYCLES)
                sync()
                t0 = time.perf_counter()
            run()
            if i in (warm - 1, warm + steps - 1):
                sync()
            if i == warm + steps - 1:
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    per_name = {}
    if cuda:
        # device-side events only, not the host ops or annotations that
        # the profiler also credits with device time
        per_name = busy_by_name(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.name)
    else:
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0 \
                    and not e.key.startswith("ProfilerStep"):
                per_name[e.key] = (e.self_cpu_time_total, e.count)
    kernels = sorted(((us, name, n) for name, (us, n) in per_name.items()),
                     reverse=True)
    return kernels, wall_us


def trace_summary(kernels, wall_us, steps, unit="epoch", top=16,
                  where="device"):
    """Per ``unit`` of a :func:`profile_steps` window: wall and busy ms
    (the union of the events' intervals), the idle share, ops, the port's kernel launches (counted from the
    device events) and µs by group (the port's kernels, the optimizer's
    multi-tensor kernels, the rest), and the ``top`` ops. ``where``
    names the busy side in the keys: ``"device"``, or ``"host"`` for a
    CPU window."""
    busy_us = sum(k[0] for k in kernels)
    groups = {"port_kernels": 0.0, "optimizer_multi_tensor": 0.0,
              "other": 0.0}
    port_launches = 0
    for us, name, n in kernels:
        if any(k in name for k in PORT_KERNEL_NAMES):
            groups["port_kernels"] += us
            port_launches += n
        elif "multi_tensor_apply" in name:
            groups["optimizer_multi_tensor"] += us
        else:
            groups["other"] += us
    return {f"wall_ms_per_{unit}": wall_us / steps / 1e3,
            f"{where}_busy_ms_per_{unit}": busy_us / steps / 1e3,
            f"{where}_idle_share": (1 - busy_us / wall_us) if kernels
            else None,
            f"{where}_ops_per_{unit}": sum(k[2] for k in kernels) / steps,
            f"port_launches_per_{unit}": port_launches / steps,
            f"us_per_{unit}_by_group": {k: v / steps
                                        for k, v in groups.items()},
            "top": [{"name": n[:80], f"us_per_{unit}": us / steps,
                     f"calls_per_{unit}": c / steps}
                    for us, n, c in kernels[:top]]}, port_launches
