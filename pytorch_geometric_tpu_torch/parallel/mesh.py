"""Device meshes, rank processes and the collectives of the port.

Counterpart of ``pytorch_geometric_tpu/parallel/mesh.py``. The JAX
package runs one controller over a ``Mesh`` of devices; here every rank
is a process of its own in one ``torch.distributed`` group: NCCL with
one rank per card, gloo on the CPU.

- :func:`make_mesh`: a ``DeviceMesh`` with named dimensions (``("dp",)``,
  ``("graph",)``) over the initialised group, ``mesh.get_group(name)``
  the process group of a dimension;
- :class:`RankPool` and :func:`spawn`: the process start that a single
  controller never needed. ``world_size`` ranks are started with
  ``spawn`` (never ``fork`` after CUDA has been initialised) and meet at
  a ``file://`` store in a fresh temporary directory, so concurrent
  groups never contend for a port; with ``world_size == 1`` the one rank
  is the calling process. An exception on any rank is raised in the
  caller, and the other ranks are stopped;
- the collectives, with their gradients: :func:`all_to_all` (its
  backward is the same all-to-all of the cotangent, the transpose JAX
  derives), :func:`ordered_sum` (a sum over the ranks in rank order,
  so that two runs repeat bitwise: NCCL fixes no order for
  ``all_reduce``) and :func:`all_gather_rows`.
"""

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
import weakref
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from pytorch_geometric_tpu_torch.device import resolve_device


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              devices=None) -> DeviceMesh:
    """A ``DeviceMesh`` over the initialised group: by default one
    dimension over every rank. ``devices`` are the global ranks to lay
    out (default ``range(world size)``), reshaped row-major to
    ``axis_sizes``; a rank outside them gets no coordinate. Every rank of
    the world calls this, as every ``new_group`` needs."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "run under RankPool / spawn")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if axis_sizes is None:
        axis_sizes = (len(ranks),)
    n = int(np.prod(axis_sizes))
    layout = torch.tensor(ranks[:n], dtype=torch.int64).reshape(
        tuple(axis_sizes))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, layout,
                      mesh_dim_names=tuple(axis_names[:layout.ndim]))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: its card (the rank's current CUDA device,
    which :class:`RankPool` sets) or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _backend_of(device) -> Tuple[torch.device, str]:
    dev = resolve_device(device)
    return dev, ("nccl" if dev.type == "cuda" else "gloo")


def _init(backend: str, init_method: str, rank: int, world_size: int,
          timeout: float):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout))


def _serve(rank, world_size, backend, init_method, timeout, tasks, results):
    """A rank's loop: run each pickled ``(fn, args)`` as ``fn(rank,
    *args)`` and send back ``(rank, ok, pickled result or traceback)``."""
    if backend == "gloo":
        torch.set_num_threads(1)
    try:
        _init(backend, init_method, rank, world_size, timeout)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        try:
            fn, args = pickle.loads(task)
            results.put((rank, True, pickle.dumps(fn(rank, *args))))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world_size`` ranks of one group that stay up between calls.

    ``device="cuda"``: NCCL, rank r on card r; more ranks than visible
    cards raise. ``device="cpu"``: gloo, one thread a rank. With
    ``world_size == 1`` the calling process is the rank (no child
    process); the group must then not be initialised already.

    ``pool.run(fn, *args)`` calls ``fn(rank, *args)`` on every rank and
    returns the results by rank; ``fn``, the arguments and the results
    cross processes by pickle, so ``fn`` lives at a module's top level
    and returns host objects. Use it as a context manager, or call
    :meth:`close`."""

    def __init__(self, world_size: int, device="cuda",
                 timeout: float = 600.0):
        dev, backend = _backend_of(device)
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if dev.type == "cuda" and world_size > torch.cuda.device_count():
            raise ValueError(
                f"{world_size} ranks need {world_size} cards; "
                f"{torch.cuda.device_count()} visible")
        self.world_size = world_size
        self.backend = backend
        self._dir = tempfile.mkdtemp(prefix="pgt_rendezvous_")
        init = "file://" + os.path.join(self._dir, "store")
        self._procs = []
        if world_size == 1:
            if dist.is_initialized():
                raise RuntimeError("a process group is already initialised "
                                   "in this process")
            _init(backend, init, 0, 1, timeout)
        else:
            ctx = mp.get_context("spawn")
            self._results = ctx.Queue()
            self._tasks = [ctx.Queue() for _ in range(world_size)]
            for r in range(world_size):
                p = ctx.Process(target=_serve, daemon=True, args=(
                    r, world_size, backend, init, timeout, self._tasks[r],
                    self._results))
                p.start()
                self._procs.append(p)
        self._finalizer = weakref.finalize(
            self, RankPool._shutdown, self._procs,
            getattr(self, "_tasks", []), getattr(self, "_results", None),
            self._dir, world_size == 1)

    def run(self, fn: Callable, *args) -> List:
        if self.world_size == 1:
            return [fn(0, *args)]
        task = pickle.dumps((fn, args))    # fails here, not in a feeder
        for q in self._tasks:
            q.put(task)
        out = {}
        while len(out) < self.world_size:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"rank(s) {dead} exited without a "
                                       "result")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        return [out[r] for r in range(self.world_size)]

    @staticmethod
    def _shutdown(procs, tasks, results, tmpdir, in_process):
        if in_process and dist.is_initialized():
            dist.destroy_process_group()
        for q in tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        # a rank exits only once its results are in the pipe: drain them
        # (those of a run abandoned on another rank's error) before joining
        deadline = time.monotonic() + 10
        while results is not None and time.monotonic() < deadline and any(
                p.is_alive() for p in procs):
            try:
                results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in procs:      # a rank still up waits in a collective
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        shutil.rmtree(tmpdir, ignore_errors=True)

    def close(self):
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spawn(fn: Callable, world_size: int, *args, device="cuda",
          timeout: float = 600.0) -> List:
    """``fn(rank, *args)`` on ``world_size`` ranks of a new group (see
    :class:`RankPool`); the results by rank."""
    with RankPool(world_size, device=device, timeout=timeout) as pool:
        return pool.run(fn, *args)


# ---------------------------------------------------------------------------
# Collectives with gradients
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x, group=None):
    """``x`` (P, ...) with row q for peer q: returns (P, ...) with row q
    from peer q (JAX ``all_to_all(split_axis=0, concat_axis=0,
    tiled=False)``). Differentiable: the backward is the same exchange of
    the cotangent."""
    return _AllToAll.apply(x, group)


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


#: the flat all-gather (``all_gather_into_tensor`` before torch 2.13)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _gather(x, group):
    """(P, ...) stack of every rank's contiguous ``x``, in rank order (a
    flat buffer: gloo takes no stacked output)."""
    if not dist.is_initialized():
        return x[None].clone()
    size = group_size(group)
    out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x.reshape(-1), group=group)
    return out.reshape((size,) + tuple(x.shape))


def all_gather_rows(x, group=None):
    """(P, ...) stack of every rank's ``x``, in rank order; no gradient."""
    return _gather(x.detach().contiguous(), group)


class _AllGather(torch.autograd.Function):
    """:func:`all_gather_rows` with a gradient: this rank's row of the
    cotangents summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        return _gather(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank], None


def all_gather(x, group=None):
    """(P, ...) stack of every rank's ``x``, differentiable."""
    return _AllGather.apply(x, group)


def ordered_sum(x, group=None):
    """Sum of every rank's ``x`` added in rank order, the same bits on
    every rank and in every run; no gradient."""
    parts = all_gather_rows(x, group)
    acc = parts[0].clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


def all_max(x, group=None):
    """Elementwise max over the ranks of a detached copy of ``x`` (JAX
    ``pmax`` under ``stop_gradient``)."""
    x = x.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x
