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

The inductive examples (examples/ppi.py, mutag_gin.py, mnist_graclus.py,
mnist_voxel_grid.py, mnist_nn_conv.py, qm9_nn_conv.py) run one step a
batch, and the JAX scripts jit that step once over the loader's static
budget. Their counterpart is :class:`CapturedStep` over a
:class:`StaticBatch`: buffers of the budget's shapes (the batch's graph,
:func:`static_graph`, and its operators' static forms, whose CSRs hold
the real entries and leave the spare slots unread). Each batch is
collated on the host and copied in on the current stream, with its
operators' CSRs (:func:`static_batches`); the first call of the step is
the warm-up, a real step on a side stream, then the capture; every later
call replays. A step that draws dropout registers its generator with the
graph (``CapturedStep(generator=)``). A training step writes its loss
into a :class:`DeviceCurve`, which the host reads once an epoch; the
evaluation is a step of its own, captured at the evaluation loader's
budget, and writes its batch's counts or sums into another. A loader
with ``dynamic_buckets`` has no single shape, so :func:`static_graph`
refuses it. examples/enzymes_topk_pool.py's steps run on MUTAG's static
batch; enzymes_diff_pool.py's dense batches keep one step a batch size.
examples/faust.py, pointnet2.py and research/driver.py's inductive
phases run their epochs through :class:`StepLoop`, which holds both
steps and both curves; examples/reddit_sage.py's sampled batches come
with their operators built by the sampler
(``data/neighbor_loader.py:NeighborSampler.iter_host``) and are copied
into static buffers of the sampler's budgets.

The full-batch loops that do host work between spans of epochs
(examples/autoencoder.py's tests, infomax.py's prints, mygcn.py's
evaluations and checkpoints, research/driver.py's ``train_part`` and its
weight corrections) run on :class:`EpochSpans`: one epoch a
:class:`CapturedStep`, its warm-up the first epoch of the first span,
each later epoch a replay, the host work between spans eager, its
launches counted as the evaluation stage of :func:`run_epochs`' form.
"""

import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.ops import (
    bsr_gat, flash_gat, fused_gcn, packed_gat, packed_rgcn, sorted_spmm,
    spmm)
from pytorch_geometric_tpu_torch.ops.csr import copy_into

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
    total = replayed_launches({"warm_up": launches["warm_up"],
                               "captured": launches["captured_epoch"],
                               "replays": launches["replays"]})
    for name, v in launches["evaluation"].items():
        total[name] = total.get(name, 0) + v
    return dict(sorted(total.items()))


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
    curve = DeviceCurve(epochs, 2, dev)

    def body():
        out = epoch_step(generator)
        curve.record(out["loss"], out["train_acc"])

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
    host = curve.host()
    metrics["curve"] = ({"loss": host[:, 0].copy(),
                         "train_acc": host[:, 1].copy()} if epochs else {})
    metrics["seconds"] = seconds
    return metrics


def _synchronize(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DeviceCurve:
    """A ``(rows, cols)`` fp32 buffer on ``dev`` and a device-side row
    counter: :meth:`record` writes the next row with no host wait (inside
    a captured graph too, where each replay writes the row after the last
    one); :meth:`host` copies rows to the host."""

    def __init__(self, rows: int, cols: int, dev: torch.device):
        self.values = torch.zeros((rows, cols), dtype=torch.float32,
                                  device=dev)
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)

    def record(self, *values):
        """Write ``values`` (device scalars, one a column) at the counter's
        row and advance it."""
        row = torch.stack([v.detach().float() for v in values])
        self.values.index_copy_(0, self.row, row[None])
        self.row.add_(1)

    def host(self, start: int = 0, stop: Optional[int] = None):
        """Rows ``start`` to ``stop`` as a numpy array (one wait for the
        card)."""
        return self.values[start:stop].cpu().numpy()


def replayed_launches(launches: Dict[str, Any]) -> Dict[str, int]:
    """The launches the card ran over a :class:`CapturedStep`'s calls,
    per wrapper, from its ``launches``: captured × replays + warm-up."""
    names = set(launches["warm_up"]) | set(launches["captured"])
    return {n: launches["captured"].get(n, 0) * launches["replays"]
            + launches["warm_up"].get(n, 0) for n in sorted(names)}


def captured_metrics(steps: Dict[str, "CapturedStep"],
                     host: Dict[str, float]) -> Dict[str, Any]:
    """What a run of captured steps reports beside its seconds:
    ``capture_seconds`` (every step's warm-up and capture),
    ``host_seconds``, ``host_collate_seconds``,
    ``host_operator_seconds``, ``host_copy_seconds`` and ``host_batches``
    (:func:`static_batches`; and whatever else ``host`` holds),
    ``launches`` by step and stage, and ``device_launches``, the launches
    the card ran, per wrapper, over all the steps."""
    total: Dict[str, int] = {}
    for step in steps.values():
        for name, v in replayed_launches(step.launches).items():
            total[name] = total.get(name, 0) + v
    return {"capture_seconds": sum(s.capture_seconds
                                   for s in steps.values()),
            **{f"host_{k}": v for k, v in host.items()},
            "launches": {k: s.launches for k, s in steps.items()},
            "device_launches": total}


class CapturedStep:
    """``body()`` over static buffers, called once a batch. Captured
    (``capture=True``, a CUDA device): the first call is the warm-up, one
    real call on a side stream (:func:`warm_up`), after which ``body`` is
    captured once (:func:`capture_epoch`); every later call replays the
    graph. Each call returns ``body``'s output: the warm-up's, then the
    captured output tensor, which each replay rewrites (read it before
    the next call). Eager (``capture=False``): ``body()`` each call.

    ``generator``: the CUDA generator ``body`` draws from (dropout),
    registered with the graph, so that each replay draws from where the
    last draw stopped: the warm-up draws once, as the first eager call
    does, and the replays then draw as the later calls would, so a
    captured run equals the eager one bitwise. A PyTorch that cannot
    register it raises (:func:`capture_epoch`).

    ``capture_seconds`` is the warm-up and the capture, up to a device
    synchronisation; ``launches`` the counted wrappers' launches by stage
    (``warm_up``, ``captured``, ``replays``; :func:`replayed_launches`).
    A capture that fails raises; nothing runs the step eagerly in its
    place. :meth:`release` drops the graph and its memory pool."""

    def __init__(self, body: Callable[[], Any], dev: torch.device,
                 capture: bool = True,
                 generator: Optional[torch.Generator] = None):
        if capture and dev.type != "cuda":
            raise ValueError(f"a captured step needs a CUDA device, got "
                             f"{dev}")
        if capture and generator is not None and \
                generator.device.type != "cuda":
            raise ValueError(f"a captured step draws from a CUDA "
                             f"generator, got one on {generator.device}")
        self.body, self.dev, self.capture = body, dev, capture
        self.generator = generator
        self.graph = None
        self.out = None
        self.capture_seconds = 0.0
        self.launches = {"warm_up": {}, "captured": {}, "replays": 0}

    def __call__(self):
        if not self.capture:
            return self.body()
        if self.graph is not None:
            self.graph.replay()
            self.launches["replays"] += 1
            return self.out
        warm, captured = [], []
        _synchronize(self.dev)
        counts = [launch_counts()]
        t0 = time.perf_counter()
        warm_up(lambda: warm.append(self.body()), self.dev)
        counts.append(launch_counts())
        self.graph = capture_epoch(lambda: captured.append(self.body()),
                                   self.generator, self.dev)
        counts.append(launch_counts())
        _synchronize(self.dev)
        self.capture_seconds = time.perf_counter() - t0
        self.out = captured[0]
        self.launches["warm_up"] = _launched(counts[1], counts[0])
        self.launches["captured"] = _launched(counts[2], counts[1])
        return warm[0]

    def release(self):
        """Drop the captured graph and its output, and so the graph's
        private memory pool; a later call raises."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None
        self.body = _released


def _released():
    raise RuntimeError("this captured step was released")


class EpochSpans:
    """A full-batch training run in spans of epochs, with host work
    between the spans: the JAX scripts' ``jax.lax.scan`` of one epoch over
    a span under ``jax.jit`` (examples/mygcn.py ``run_span``,
    research/driver.py ``train_part``; the jitted epochs of
    examples/autoencoder.py and infomax.py), the evaluation, printing,
    checkpoints and weight corrections between two spans.

    ``epoch_step()`` takes one optimizer step and returns the epoch's
    device scalars (the loss, or a tuple of ``cols``); each epoch writes
    them into the next row of ``curve``, a :class:`DeviceCurve` of
    ``epochs`` rows. The epoch is a :class:`CapturedStep`: captured, the
    first epoch of the first span is its warm-up, so a run takes exactly
    the epochs its spans add up to, as the scans do, and every later
    epoch replays the graph. ``generator`` is the one the step draws from
    (dropout, noise, permutations), registered with the graph. Eager, the
    same body runs from Python each epoch.

    :meth:`span` runs a span and returns its rows on the host (one wait);
    :meth:`between` runs the host work, its counted launches kept as the
    ``evaluation`` stage; :attr:`launches` has :func:`run_epochs`'s form,
    so :func:`device_launches` states the run's launches. ``seconds`` is
    the spans' wall time (the warm-up and the capture included; their
    share is ``capture_seconds``), ``between_seconds`` the host work's."""

    def __init__(self, epoch_step: Callable[[], Any], epochs: int,
                 dev: torch.device, capture: bool = False,
                 generator: Optional[torch.Generator] = None,
                 cols: int = 1):
        self.curve = DeviceCurve(epochs, cols, dev)

        def body():
            out = epoch_step()
            self.curve.record(*(out if isinstance(out, tuple) else (out,)))

        self.step = CapturedStep(body, dev, capture, generator)
        self.epoch_step, self.dev = epoch_step, dev
        self.epochs = 0
        self.seconds = self.between_seconds = 0.0
        self.evaluation: Dict[str, int] = {}

    def span(self, length: int):
        """``length`` epochs; their rows of the curve as a numpy array."""
        t0 = time.perf_counter()
        for _ in range(length):
            self.step()
        rows = self.curve.host(self.epochs, self.epochs + length)
        self.seconds += time.perf_counter() - t0
        self.epochs += length
        return rows

    def between(self, fn: Callable[..., Any], *args, **kwargs):
        """``fn(*args, **kwargs)``, the host work between two spans."""
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(self.dev)
        self.between_seconds += time.perf_counter() - t0
        for name, v in _launched(launch_counts(), before).items():
            self.evaluation[name] = self.evaluation.get(name, 0) + v
        return out

    def again(self, epochs: int) -> "EpochSpans":
        """The same epoch, generator and mode over ``epochs`` more epochs,
        with a curve of its own (captured: a capture of its own), from the
        model's state as it stands: a profiler's window of epochs."""
        return EpochSpans(self.epoch_step, epochs, self.dev,
                          self.step.capture, self.step.generator,
                          self.curve.values.shape[1])

    @property
    def capture_seconds(self) -> float:
        return self.step.capture_seconds

    @property
    def launches(self) -> Dict[str, Any]:
        """The counted wrappers' launches by stage: ``warm_up``,
        ``captured_epoch``, ``replays`` and ``evaluation`` (the host work
        between spans)."""
        stages = self.step.launches
        return {"warm_up": stages["warm_up"],
                "captured_epoch": stages["captured"],
                "replays": stages["replays"],
                "evaluation": dict(sorted(self.evaluation.items()))}

    def metrics(self) -> Dict[str, Any]:
        """What a run reports of its spans: ``seconds``,
        ``between_seconds``, and, captured, ``capture_seconds``,
        ``launches`` by stage and ``device_launches``."""
        out = {"seconds": self.seconds,
               "between_seconds": self.between_seconds}
        if self.step.capture:
            out.update(capture_seconds=self.capture_seconds,
                       launches=self.launches,
                       device_launches=device_launches(self.launches))
        return out


def static_graph(loader, device) -> Graph:
    """A graph of ``loader``'s static budget (nodes, edges, graphs) whose
    tensors are new buffers on ``device``: one record of its dataset
    collated at the budget gives the shapes and dtypes, and no batch
    order is drawn. A loader with ``dynamic_buckets`` pads each batch to
    its own size, so no captured step has one shape for it: it raises."""
    if getattr(loader, "dynamic_buckets", False):
        raise ValueError("a loader with dynamic_buckets has no single "
                         "static shape to capture a step over (pass "
                         "capture=False, or a loader without it)")
    return collate([loader.dataset[0]], num_nodes=loader.num_nodes,
                   num_edges=loader.num_edges, num_graphs=loader.num_graphs,
                   device="cpu").to(device)


def _tensors(graph: Graph) -> Dict[str, torch.Tensor]:
    fields = {name: getattr(graph, name) for name in (
        "senders", "receivers", "x", "edge_attr", "pos", "y", "node_mask",
        "edge_mask", "batch")}
    fields.update({f"extras.{k}": v for k, v in graph.extras.items()})
    return {k: v for k, v in fields.items() if isinstance(v, torch.Tensor)}


def load_graph(static: Graph, graph: Graph) -> Graph:
    """Copy ``graph``'s tensors into ``static``'s buffers in place, on the
    current stream and without a host wait (a host batch through pinned
    memory). The two must have the same fields, shapes and dtypes."""
    dst, src = _tensors(static), _tensors(graph)
    if set(dst) != set(src) or static.num_graphs != graph.num_graphs or \
            any(dst[k].shape != v.shape or dst[k].dtype != v.dtype
                for k, v in src.items()):
        raise ValueError(
            "the batch does not fit the static graph: "
            f"{ {k: (tuple(v.shape), v.dtype) for k, v in src.items()} }, "
            f"{graph.num_graphs} graphs against "
            f"{ {k: (tuple(v.shape), v.dtype) for k, v in dst.items()} }, "
            f"{static.num_graphs}")
    for k, v in src.items():
        copy_into(dst[k], v)
    return static


class StaticBatch:
    """The static buffers of one loader's budget on ``device``: ``graph``
    (:func:`static_graph`) and ``ops``, the batch's operators in their
    static forms (each with ``load``). A captured step reads only these."""

    def __init__(self, loader, ops: Dict[str, Any], device):
        self.graph = static_graph(loader, device)
        self.ops = ops

    def load(self, graph: Graph, ops: Dict[str, Any]):
        """Copy a batch and its operators in (same names as ``ops``)."""
        if set(ops) != set(self.ops):
            raise ValueError(f"operators {sorted(ops)}, the static batch "
                             f"holds {sorted(self.ops)}")
        load_graph(self.graph, graph)
        for name, op in ops.items():
            self.ops[name].load(op)


def static_batches(loader, operators: Callable, static: StaticBatch,
                   host: Dict[str, float]) -> Iterator[Graph]:
    """One epoch of ``loader``, collated on the host: each batch's
    operators (``operators(indices, graph)``, a dict of ``static``'s
    names) and the batch itself copied into ``static``; yields the host
    batch once the copies are enqueued. ``host["seconds"]`` adds each
    batch's host time (collation, the operators' build or lookup, the
    copies), ``host["collate_seconds"]``, ``host["operator_seconds"]``
    and ``host["copy_seconds"]`` the collation's, the operators' and the
    copies' shares (staging in pinned memory and enqueueing), and
    ``host["batches"]`` counts them."""
    batches = loader.indexed(device="cpu")
    while True:
        t0 = time.perf_counter()
        try:
            idx, graph = next(batches)
        except StopIteration:
            return
        t1 = time.perf_counter()
        ops = operators(idx, graph)
        t2 = time.perf_counter()
        static.load(graph, ops)
        t3 = time.perf_counter()
        for key, dt in (("seconds", t3 - t0), ("collate_seconds", t1 - t0),
                        ("operator_seconds", t2 - t1),
                        ("copy_seconds", t3 - t2), ("batches", 1)):
            host[key] = host.get(key, 0) + dt
        yield graph


class StepLoop:
    """The epochs of an inductive run: one training step a batch of the
    train loader, then one evaluation a batch of the test loader, the way
    examples/faust.py, pointnet2.py, reddit_sage.py and
    research/driver.py's inductive phases run them. ``step(graph, ops)``
    takes one optimizer step and returns its loss, a device scalar, which
    goes into the next row of a :class:`DeviceCurve`; ``count(graph,
    ops)`` (run without gradients) returns the batch's ``cols`` device
    scalars (correct and total, or true and false positives and false
    negatives), which go into another. ``operators`` is ``(train,
    test)``: each a function of a batch's dataset indices and its graph
    that returns its operators (a dict; an ``examples/ppi.py:
    OperatorCache``). ``operators`` None: each of ``loaders`` is a source
    of host batches instead, an iterable (its ``len`` the batches an
    epoch) of ``(graph, ops)`` collated on the host with their operators
    (examples/reddit_sage.py's sampled batches).

    Captured (``capture``, a CUDA device): ``statics`` is the ``(train,
    test)`` pair of static buffers (:class:`StaticBatch` es, or any with
    its ``graph``, ``ops`` and ``load(graph, ops)``), each step a
    :class:`CapturedStep` over one of them (the training step draws from
    ``generator``, registered with its graph), each batch collated on the
    host and copied in with its operators (:func:`static_batches`), then a
    replay. Eager: the same steps over each batch's own tensors (a host
    source's copied to ``dev`` first). ``host`` is the dict the host
    times go into (:func:`static_batches`' keys; default: a new one)."""

    def __init__(self, loaders, operators, step: Callable, count: Callable,
                 epochs: int, dev: torch.device, capture: bool = False,
                 statics=None, generator: Optional[torch.Generator] = None,
                 cols: int = 2, host: Optional[Dict[str, float]] = None):
        self.loaders, self.operators, self.dev = loaders, operators, dev
        self.sizes = (len(loaders[0]), len(loaders[1]))
        self.curve = DeviceCurve(epochs * self.sizes[0], 1, dev)
        self.tally = DeviceCurve(epochs * self.sizes[1], cols, dev)
        self.step_fn, self.capture, self.statics = step, capture, statics
        self.count_fn = count
        self.host: Dict[str, float] = {} if host is None else host
        self.epochs = 0
        if capture:
            train, test = statics
            self.steps = {
                "train": CapturedStep(lambda: self._train(train.graph,
                                                          train.ops),
                                      dev, generator=generator),
                "evaluation": CapturedStep(lambda: self._count(
                    test.graph, test.ops), dev)}

    def _train(self, graph: Graph, ops):
        self.curve.record(self.step_fn(graph, ops))

    def _count(self, graph: Graph, ops):
        with torch.no_grad():
            self.tally.record(*self.count_fn(graph, ops))

    def _batches(self, which: int):
        """One epoch of the ``which`` loader: ``(graph, ops)`` on the
        device, or, captured, once each batch is copied into its static
        buffers."""
        loader = self.loaders[which]
        if self.operators is None:
            yield from self._host_batches(which)
        elif self.capture:
            for graph in static_batches(loader, self.operators[which],
                                        self.statics[which], self.host):
                yield graph, None
        else:
            for idx, graph in loader.indexed():
                yield graph, self.operators[which](idx, graph)

    def _host_batches(self, which: int):
        batches = iter(self.loaders[which])
        while True:
            t0 = time.perf_counter()
            try:
                graph, ops = next(batches)
            except StopIteration:
                return
            t1 = time.perf_counter()
            if self.capture:
                self.statics[which].load(graph, ops)
            else:
                graph = graph.to(self.dev)
                ops = {k: op.to(self.dev) for k, op in ops.items()}
            t2 = time.perf_counter()
            for key, dt in (("seconds", t2 - t0), ("collate_seconds", t1 - t0),
                            ("copy_seconds", t2 - t1), ("batches", 1)):
                self.host[key] = self.host.get(key, 0) + dt
            yield graph, ops

    def epoch(self):
        """One epoch: ``(losses, counts)`` on the host, every training
        step's loss and the evaluation's counts summed over the test
        batches (float64; one wait for the card each)."""
        for which, run in ((0, self._train), (1, self._count)):
            step = self.steps["train" if which == 0 else "evaluation"] \
                if self.capture else None
            for graph, ops in self._batches(which):
                if step is not None:
                    step()
                else:
                    run(graph, ops)
        e, (n, m) = self.epochs, self.sizes
        self.epochs += 1
        return (self.curve.host(e * n, (e + 1) * n)[:, 0],
                self.tally.host(e * m, (e + 1) * m).astype("float64").sum(0))

    def metrics(self) -> Dict[str, Any]:
        """Captured, :func:`captured_metrics` of both steps; else empty."""
        return captured_metrics(self.steps, self.host) if self.capture \
            else {}

    def release(self):
        """Release both captured steps' graphs
        (:meth:`CapturedStep.release`)."""
        if self.capture:
            for step in self.steps.values():
                step.release()
