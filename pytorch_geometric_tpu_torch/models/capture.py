"""The training run of every trainer of the port: ``epochs`` optimizer
steps and one evaluation, on a CUDA device as one captured CUDA graph.

The JAX trainers run the whole training run as one device program
(``jax.lax.scan`` over the epoch step under one ``jax.jit``;
``pytorch_geometric_tpu/models/citation.py:train_gcn``, examples/gat.py
and examples/rgcn.py ``train_all``). The port's counterpart,
:func:`run_epochs` with ``capture=True``:

1. the first epoch runs eagerly, on a side stream (:func:`warm_up`). It
   is a real step, and it does every first-call work: the kernel
   libraries load, the kernels set their attributes, the operators cache
   their int seed tensors, the optimizer allocates its state and the
   gradients are allocated;
2. the second epoch is captured once in a ``torch.cuda.CUDAGraph``
   (:func:`capture_epoch`): forward, backward and optimizer step, the
   dropout draws from the run's generator (registered with the graph, so
   every replay draws afresh), and the epoch's loss and training accuracy
   written into a preallocated ``(epochs, 2)`` device buffer at the row
   of a device-side epoch counter that the graph increments;
3. the graph is replayed once for each of the ``epochs - 1`` remaining
   epochs. Then the evaluation runs eagerly once (the JAX trainers'
   separate ``jax.jit(eval_fn)``), and the curve is copied to the host.

So a captured run takes exactly ``epochs`` steps, as the scan does. A
capture that fails raises; nothing runs the epochs eagerly in its place.
Capture refuses a host synchronisation or a host-to-device copy inside
the step, so a capture that succeeds shows the step makes none.

``capture=None`` means captured on a CUDA device and eager on the CPU
(:func:`resolve_capture`); ``capture=False`` keeps the eager loop on the
card (for the profiler's trace and for debugging), which runs the same
body, buffer and counter included, ``epochs`` times from Python.

A wrapper's ``.launches`` counts its Python calls, and a replay makes
none. A captured run therefore reports its launches by stage
(``metrics["launches"]``: the warm-up epoch, the captured epoch, the
number of replays, the evaluation), and :func:`device_launches` states
the launches the card ran as captured × replays + warm-up + evaluation.
"""

import time
from typing import Any, Callable, Dict, Optional

import torch

from pytorch_geometric_tpu_torch.ops import (
    bsr_gat, flash_gat, fused_gcn, packed_gat, packed_rgcn, sorted_spmm,
    spmm)

#: Every kernel wrapper of the port that counts its launches.
COUNTED_WRAPPERS = (spmm.spmm_csr, packed_gat.packed_gat_fwd,
                    packed_gat.packed_gat_bwd, flash_gat.flash_gat_fwd,
                    flash_gat.flash_gat_bwd, bsr_gat.bsr_gat_fwd,
                    bsr_gat.bsr_gat_bwd_row, bsr_gat.bsr_gat_bwd_col,
                    packed_rgcn.packed_rgcn_fwd, packed_rgcn.packed_rgcn_bwd,
                    sorted_spmm.sorted_segment_sum, fused_gcn.fused_gcn_fwd,
                    fused_gcn.fused_gcn_bwd)


def resolve_capture(capture: Optional[bool], dev: torch.device) -> bool:
    """Whether a run on ``dev`` is captured: ``None`` means on a CUDA
    device only; ``True`` on another device raises."""
    if capture is None:
        return dev.type == "cuda"
    if capture and dev.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, got {dev}: a "
                         "CUDA graph holds device work only (pass "
                         "capture=None or False to run the epochs eagerly)")
    return bool(capture)


def launch_counts() -> Dict[str, int]:
    """Every counted wrapper's ``.launches``, by the wrapper's name."""
    return {w.__name__: w.launches for w in COUNTED_WRAPPERS}


def _launched(after: Dict[str, int], before: Dict[str, int]):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def device_launches(launches: Dict[str, Any]) -> Dict[str, int]:
    """The launches the card ran over a captured run, per wrapper, from
    its ``metrics["launches"]``: captured epoch × replays + warm-up +
    evaluation."""
    names = sorted(set(launches["warm_up"]) | set(launches["captured_epoch"])
                   | set(launches["evaluation"]))
    return {n: launches["captured_epoch"].get(n, 0) * launches["replays"]
            + launches["warm_up"].get(n, 0)
            + launches["evaluation"].get(n, 0) for n in names}


def warm_up(body: Callable[[], Any], dev: torch.device):
    """One eager call of ``body`` on a side stream, joined back to the
    current stream: the first-call work happens outside the capture, as
    ``torch.cuda.graphs`` asks of a warm-up."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)


def capture_epoch(body: Callable[[], Any],
                  generator: Optional[torch.Generator],
                  dev: torch.device) -> torch.cuda.CUDAGraph:
    """``body`` captured once in a CUDA graph (it does not run). The
    default generator is registered by the capture itself; ``generator``,
    if given, is registered here, so that every replay draws from where
    the last draw stopped, as an eager call would."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                f"PyTorch {torch.__version__} has no "
                "CUDAGraph.register_generator_state: a captured epoch could "
                "not draw afresh from the run's generator on each replay "
                "(pass capture=False to run the epochs eagerly)")
        register(generator)
    with torch.cuda.device(dev), torch.cuda.graph(graph):
        body()
    return graph


def run_epochs(epoch_step, eval_fn, epochs: int,
               generator: Optional[torch.Generator], dev: torch.device,
               capture: bool = False) -> Dict[str, Any]:
    """``epochs`` steps of ``epoch_step(generator)`` (which returns the
    epoch's ``loss`` and ``train_acc`` as device scalars), then one
    ``eval_fn()``; shared by every trainer of the port. Each epoch writes
    its loss and accuracy into a device buffer at the row of a device-side
    counter; the curve is copied to the host once, at the end.

    Eager (``capture=False``): the epochs are called from Python; the
    metrics are the evaluation's accuracies, ``curve`` (numpy ``loss`` and
    ``train_acc``) and ``seconds``, the wall time of the epochs and the
    evaluation up to a device synchronisation. Captured (``capture=True``,
    a CUDA device; see the module docstring): ``seconds`` covers the
    ``epochs - 1`` replays and the evaluation, and ``capture_seconds`` the
    warm-up epoch and the capture; ``launches`` gives the counted
    wrappers' launches by stage (``warm_up``, ``captured_epoch``,
    ``replays``, ``evaluation``)."""
    if capture and epochs < 1:
        raise ValueError(f"a captured run needs at least one epoch, got "
                         f"{epochs}")
    curve = torch.zeros((epochs, 2), dtype=torch.float32, device=dev)
    epoch = torch.zeros(1, dtype=torch.int64, device=dev)

    def body():
        out = epoch_step(generator)
        row = torch.stack([out["loss"].float(), out["train_acc"].float()])
        curve.index_copy_(0, epoch, row[None])
        epoch.add_(1)

    metrics: Dict[str, Any] = {}
    _synchronize(dev)
    if capture:
        counts = [launch_counts()]
        t0 = time.perf_counter()
        warm_up(body, dev)
        counts.append(launch_counts())
        graph = capture_epoch(body, generator, dev)
        counts.append(launch_counts())
        _synchronize(dev)
        t1 = time.perf_counter()
        for _ in range(epochs - 1):
            graph.replay()
        final = eval_fn()
        _synchronize(dev)
        seconds = time.perf_counter() - t1
        counts.append(launch_counts())
        metrics["capture_seconds"] = t1 - t0
        metrics["launches"] = {
            "warm_up": _launched(counts[1], counts[0]),
            "captured_epoch": _launched(counts[2], counts[1]),
            "replays": epochs - 1,
            "evaluation": _launched(counts[3], counts[2])}
    else:
        t0 = time.perf_counter()
        for _ in range(epochs):
            body()
        final = eval_fn()
        _synchronize(dev)
        seconds = time.perf_counter() - t0

    metrics.update({k: float(v) for k, v in final.items()})
    host = curve.cpu().numpy()
    metrics["curve"] = ({"loss": host[:, 0].copy(),
                         "train_acc": host[:, 1].copy()} if epochs else {})
    metrics["seconds"] = seconds
    return metrics


def _synchronize(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
