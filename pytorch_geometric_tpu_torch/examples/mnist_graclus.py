"""SplineConv and graclus coarsening on MNIST superpixels: the port's
counterpart of examples/mnist_graclus.py. ``SplineConv(1 -> 32, dim 2,
kernel_size 5)`` with an ELU, ``pool_graph_masked(cluster1, "max")``,
Cartesian pseudo-coordinates of the pooled positions
(:func:`device_cartesian`), ``SplineConv(32 -> 64)`` with an ELU, a
second pool over ``cluster2``, ``global_mean_pool``, Dense 128 (ELU,
dropout 0.5) and Dense 10; the masked cross-entropy, Adam 0.01, batches
of 64 shuffled from ``seed``, test accuracy after each epoch. The graclus
levels are computed per sample at load time
(``PrecomputeGraclusCoarsening``), as in the JAX script.

    python -m pytorch_geometric_tpu_torch.examples.mnist_graclus \\
        [--epochs 3]

The JAX script jits its training step and its evaluation once over the
loaders' static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget (:func:`static_batch`: the
graph, both levels' static spline operators and the static segment sums
of both pools and the readout). Each batch's operator set
(:func:`mnist_operators`) is built on the host in an ``examples/ppi.py:
OperatorCache``, staged in pinned memory and copied in without a host
wait before the replay; the dropout draws from the run's CUDA generator,
which the training graph registers, so a captured run equals the eager
one bitwise. Shuffled batches are new each epoch, so the train operator
sets are built anew every epoch; the test batches' once. Positions,
clusters and masks are known on the host, so the host runs the
coarsened level's geometry with the port's own functions on a CPU copy
of the batch (``pool_graph_masked`` and :func:`device_cartesian`), and
every sum of the step goes through a kernel on the card, over the
batch's real entries only:

- conv1 and conv2: each level's rectangular spline operator
  (``spline_operator``; the ``spmm_csr`` kernel, one launch a forward,
  one for conv2's ``dx``; conv1's input takes no gradient);
- both pools' means of ``pos``: ``cluster_operator`` over the real nodes
  (the segment-sum kernel; the maxima are torch's ``scatter_reduce``);
- the readout: level 2's ``pool_operator`` over its occupied rows (the
  segment-sum kernel; its backward is a gather).

So a step launches ``spmm_csr`` 3 times and the segment sum 3 times, an
evaluation batch 2 and 3. Each step's loss and each test batch's correct
and total counts are written into device buffers, which the host reads
once an epoch. ``capture=False`` runs the same steps eagerly over each
batch's own tensors (the CPU's only mode). Prints the JAX script's line
per epoch.
"""

import argparse
import functools
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import MNISTSuperpixels
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, StaticBatch, captured_metrics,
    resolve_capture, static_batches)
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import (
    SplineConv, spline_operator, static_spline_operator)
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.nn.pool import (
    cluster_operator, global_mean_pool, pool_graph_masked, pool_operator)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    SortedSegmentSum, StaticSegmentSum)
from pytorch_geometric_tpu_torch.transforms import Cartesian, Compose
from pytorch_geometric_tpu_torch.transforms.coarsen_levels import (
    PrecomputeGraclusCoarsening)

DIM, KERNEL_SIZE = 2, 5


def device_cartesian(graph: Graph) -> Graph:
    """Normalised Cartesian pseudo-coordinates from ``pos``: one scale for
    the whole batch, the largest |Δpos| over the kept edges (the reference
    re-applies ``Cartesian`` inside ``max_pool``)."""
    rel = graph.pos.index_select(0, graph.receivers.long()) \
        - graph.pos.index_select(0, graph.senders.long())
    em = graph.real_edge_mask()
    scale = torch.where(em[:, None], rel.abs(), 0.0).max()
    pseudo = rel / (2 * scale.clamp_min(1e-12)) + 0.5
    return graph.replace(edge_attr=pseudo)


def coarsened_levels(graph: Graph):
    """``(level 1, level 2)`` of a batch, without features, on the
    batch's device (the CPU, where the host builds them):
    ``pool_graph_masked`` over ``cluster1`` with :func:`device_cartesian`,
    then over ``cluster2``, as the forward runs them (relabelled edges with
    their duplicates, collapsed self loops masked off, occupied rows,
    pooled positions and batch)."""
    g0 = graph.replace(x=None, edge_attr=None)
    g1 = device_cartesian(pool_graph_masked(g0.extras["cluster1"], g0))
    g2 = pool_graph_masked(g0.extras["cluster2"], g1)
    return g1, g2


def mnist_operators(graph: Graph, segment_ops: bool = False, host=None):
    """The operator set of a batch on its device, built on the host from
    its positions and precomputed clusters, each over the batch's real
    entries: ``conv1`` and ``conv2``, the spline operators of level 0
    (the batch's ``edge_attr``) and of level 1
    (:func:`coarsened_levels`); ``pool1`` and ``pool2``, the
    ``cluster_operator`` s of ``cluster1`` over level 0 and of
    ``cluster2`` over level 1 (the means of ``pos``); ``readout``, level
    2's ``pool_operator``. ``segment_ops``: also ``segment1`` and
    ``segment2``, each level's ``SortedSegmentSum`` over its receivers
    (the relabelled ones at level 1) and its real edges (level 1's keep
    no collapsed self loop), for NNConv's sums, and ``senders2``, level
    1's over its senders, through which conv2 gathers its input
    (examples/mnist_nn_conv.py). ``host``: a dict whose
    ``"geometry_seconds"`` adds the host time of the coarsened levels."""
    dev = graph.device
    t0 = time.perf_counter()
    g0 = graph.to("cpu")
    g1, g2 = coarsened_levels(g0)
    if host is not None:
        host["geometry_seconds"] = host.get("geometry_seconds", 0.0) + \
            time.perf_counter() - t0
    ops = {"conv1": spline_operator(g0, DIM, KERNEL_SIZE, device=dev),
           "conv2": spline_operator(g1, DIM, KERNEL_SIZE, device=dev),
           "pool1": cluster_operator(g0.extras["cluster1"], g0, device=dev),
           "pool2": cluster_operator(g0.extras["cluster2"], g1, device=dev),
           "readout": pool_operator(g2, device=dev)}
    if segment_ops:
        for k, g in ((1, g0), (2, g1)):
            ops[f"segment{k}"] = SortedSegmentSum(
                g.receivers, g.num_nodes, entry_mask=g.real_edge_mask(),
                device=dev)
        ops["senders2"] = SortedSegmentSum(
            g1.senders, g1.num_nodes, entry_mask=g1.real_edge_mask(),
            device=dev)
    return ops


def static_batch(loader: DataLoader, device,
                 segment_ops: bool = False) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph
    and the static forms of :func:`mnist_operators`' set (the spline
    operators with a slot for each of an edge's four corners, the pools'
    and the readout's segment sums with a slot for each node; with
    ``segment_ops``, NNConv's sums by receiver and level 1's gather by
    sender, a slot for each edge)."""
    n, e = loader.num_nodes, loader.num_edges
    ops = {f"conv{k}": static_spline_operator(n, e, DIM, KERNEL_SIZE,
                                              device=device)
           for k in (1, 2)}
    ops.update({"pool1": StaticSegmentSum(n, n, device=device),
                "pool2": StaticSegmentSum(n, n, device=device),
                "readout": StaticSegmentSum(loader.num_graphs, n,
                                            device=device)})
    if segment_ops:
        for name in ("segment1", "segment2", "senders2"):
            ops[name] = StaticSegmentSum(n, e, device=device)
    return StaticBatch(loader, ops, device)


class Net(nn.Module):
    """examples/mnist_graclus.py's ``Net``, with its parameter names
    (``conv1``, ``conv2``, ``Dense_0``, ``Dense_1``), so that
    ``convert.params_from_jax`` carries the flax parameters across."""

    def __init__(self, num_classes: int = 10, generator=None):
        super().__init__()
        self.conv1 = SplineConv(1, 32, dim=DIM, kernel_size=KERNEL_SIZE,
                                generator=generator)
        self.conv2 = SplineConv(32, 64, dim=DIM, kernel_size=KERNEL_SIZE,
                                generator=generator)
        self.Dense_0 = Dense(64, 128, generator=generator)
        self.Dense_1 = Dense(128, num_classes, generator=generator)

    def forward(self, graph: Graph, *, train: bool = False, ops=None,
                generator=None):
        """``ops``: :func:`mnist_operators` of the batch (required on a
        card; without it, on the CPU, the plain segment ops and the level
        geometry from the device functions)."""
        ops = ops or {}
        x = F.elu(self.conv1(graph, graph.x, spline_op=ops.get("conv1")))
        g = pool_graph_masked(graph.extras["cluster1"], graph.replace(x=x),
                              reduce="max", segment_op=ops.get("pool1"))
        # the host built level 1's pseudo-coordinates into ops["conv2"]
        g = g if "conv2" in ops else device_cartesian(g)
        x = F.elu(self.conv2(g, g.x, spline_op=ops.get("conv2")))
        g = pool_graph_masked(graph.extras["cluster2"], g.replace(x=x),
                              reduce="max", segment_op=ops.get("pool2"))
        return head(self, global_mean_pool(g.x, g,
                                           segment_op=ops.get("readout")),
                    train, generator)


def head(model: nn.Module, h, train: bool, generator):
    """Dense 128 (ELU), dropout 0.5, Dense to the classes."""
    h = F.elu(model.Dense_0(h))
    return model.Dense_1(dropout(h, 0.5, train, generator))


def loss_of(logits, graph: Graph):
    """The JAX script's loss: cross-entropy over the real graphs."""
    return graph_xent_loss(logits, graph.y, graph.graph_mask)


def train_step(model: nn.Module, opt, graph: Graph, ops, generator=None,
               train: bool = True):
    """One Adam step on one batch, with dropout unless ``train`` is
    False, the gradients zeroed in place (a captured step keeps them);
    the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model(graph, train=train, ops=ops, generator=generator),
                   graph)
    loss.backward()
    opt.step()
    return loss.detach()


def counts_of(model: nn.Module, graph: Graph, ops):
    """``(correct, total)`` of the argmax over the batch's real graphs, as
    device scalars (the JAX script's ``eval_step``)."""
    with torch.no_grad():
        pred = model(graph, ops=ops).argmax(dim=1)
    m = graph.graph_mask
    return ((pred == graph.y.long()) & m).sum(), m.sum()


def captured_steps(model: nn.Module, opt, train_loader: DataLoader,
                   test_loader: DataLoader, steps: int, dev, generator,
                   segment_ops: bool = False, evals: int = 0):
    """``(train, test, step, predict, (curve, tally))``: the static
    batches of both loaders (:func:`static_batch`), the training step
    over ``train`` (dropout from ``generator``, registered with its
    graph; its loss into the next row of ``curve``, a
    :class:`DeviceCurve` of ``steps`` rows) and the evaluation over
    ``test`` (its batch's correct and total into the next row of
    ``tally``, ``evals`` rows), each a :class:`CapturedStep`."""
    train = static_batch(train_loader, dev, segment_ops)
    test = static_batch(test_loader, dev, segment_ops)
    curve, tally = DeviceCurve(steps, 1, dev), DeviceCurve(evals, 2, dev)
    step = CapturedStep(lambda: curve.record(train_step(
        model, opt, train.graph, train.ops, generator)), dev,
        generator=generator)
    predict = CapturedStep(lambda: tally.record(*counts_of(
        model, test.graph, test.ops)), dev)
    return train, test, step, predict, (curve, tally)


def load(seed: int = 0, batch_size: int = 64, train_samples: int = 1500,
         root=PLANETOID_ROOT, transform=None, device="cuda"):
    """``(train loader, test loader)`` of the JAX script: MNISTSuperpixels
    under ``root`` (``train_samples`` synthetic training graphs, a sixth
    of them for the test) through ``transform`` (default
    ``Compose([Cartesian(), PrecomputeGraclusCoarsening(levels=2)])``),
    the train loader shuffled from ``seed``."""
    pre = transform or Compose([Cartesian(),
                                PrecomputeGraclusCoarsening(levels=2)])
    train_ds = MNISTSuperpixels(str(root), train=True, pre_transform=pre,
                                num_synthetic=train_samples)
    test_ds = MNISTSuperpixels(str(root), train=False, pre_transform=pre,
                               num_synthetic=train_samples)
    return (DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                       seed=seed, device=device),
            DataLoader(test_ds, batch_size=batch_size, device=device))


def fit(model: nn.Module, loaders, epochs: int, seed: int, dev,
        segment_ops: bool = False, lr: float = 0.01, capture: bool = False):
    """The scripts' loop: Adam ``lr`` (capturable on a card), dropout
    drawn from a ``dev`` generator seeded with ``seed``, one operator set
    a distinct batch (:func:`mnist_operators`, with the NNConv sums if
    ``segment_ops``), each step's loss and each test batch's counts in
    device buffers read once an epoch, the JAX line per epoch. Captured
    (``capture``): the steps of :func:`captured_steps`, each batch and
    its operators copied into their static buffers
    (``models/capture.py:static_batches``); eager: the same steps over
    each batch's own tensors. Returns the last test accuracy, the mean
    loss of each epoch, every step's loss, the operator sets built, the
    host seconds their build took (``geometry_seconds`` the coarsened
    levels' share), the run's seconds and the model; a captured run adds
    ``models/capture.py:captured_metrics``."""
    train_loader, test_loader = loaders
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           capturable=dev.type == "cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    host = {}
    build = functools.partial(mnist_operators, segment_ops=segment_ops,
                              host=host)
    train_ops, test_ops = OperatorCache(build), OperatorCache(build)
    n_train, n_test = len(train_loader), len(test_loader)
    if capture:
        train, test, step, predict, (curve, tally) = captured_steps(
            model, opt, train_loader, test_loader, epochs * n_train, dev,
            gen, segment_ops, epochs * n_test)
    else:
        curve = DeviceCurve(epochs * n_train, 1, dev)
        tally = DeviceCurve(epochs * n_test, 2, dev)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        if capture:
            for _ in static_batches(train_loader, train_ops, train, host):
                step()
            for _ in static_batches(test_loader, test_ops, test, host):
                predict()
        else:
            for idx, graph in train_loader.indexed():
                curve.record(train_step(model, opt, graph,
                                        train_ops(idx, graph), gen))
            for idx, graph in test_loader.indexed():
                tally.record(*counts_of(model, graph, test_ops(idx, graph)))
        losses = curve.host((epoch - 1) * n_train, epoch * n_train)[:, 0]
        correct, total = tally.host((epoch - 1) * n_test,
                                    epoch * n_test).sum(0)
        acc = float(correct) / max(float(total), 1.0)
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {acc:.4f}")
    out = {"acc": acc, "epoch_losses": epoch_losses,
           "step_losses": np.stack(step_losses),
           "operators": len(train_ops.ops) + len(test_ops.ops),
           "operator_seconds": train_ops.seconds + test_ops.seconds,
           "geometry_seconds": host.get("geometry_seconds", 0.0),
           "seconds": time.perf_counter() - t0, "model": model}
    if capture:
        out.update(captured_metrics(
            {"train": step, "evaluation": predict}, host))
    return out


def run(epochs: int = 3, batch_size: int = 64, seed: int = 0,
        train_samples: int = 1500, device="cuda", loaders=None,
        capture=None):
    """Train and print the JAX script's line per epoch; ``loaders``
    (train, test) replaces :func:`load`'s. ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU; True
    elsewhere than a card raises. Returns :func:`fit`'s record."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    loaders = loaders or load(seed, batch_size, train_samples, device=dev)
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    next(iter(loaders[0]))
    model = Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    return fit(model, loaders, epochs, seed, dev, capture=capture)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
