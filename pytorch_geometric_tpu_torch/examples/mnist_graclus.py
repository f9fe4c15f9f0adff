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

The JAX script jits one step over each collated batch. Here the step runs
eagerly over one operator set of the batch (:func:`mnist_operators`, built
on the host once per distinct batch in an ``examples/ppi.py:
OperatorCache``). Positions, clusters and masks are known on the host, so
the host runs the coarsened level's geometry with the port's own
functions on a CPU copy of the batch (``pool_graph_masked`` and
:func:`device_cartesian`), and every sum of the step goes through a
kernel on the card:

- conv1 and conv2: each level's rectangular spline operator
  (``spline_operator``; the ``spmm_csr`` kernel, one launch a forward,
  one for conv2's ``dx``; conv1's input takes no gradient);
- both pools' means of ``pos``: ``cluster_operator`` (the segment-sum
  kernel; the maxima are torch's ``scatter_reduce``);
- the readout: level 2's ``pool_operator``, its unoccupied rows routed to
  the padding graph (the segment-sum kernel; its backward is a gather).

So a step launches ``spmm_csr`` 3 times and the segment sum 3 times, an
evaluation batch 2 and 3. Shuffled batches are new each epoch, so the
train operator sets are built anew every epoch; the test batches' once.
Prints the JAX script's line per epoch.
"""

import argparse
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
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import SplineConv, spline_operator
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.nn.pool import (
    cluster_operator, global_mean_pool, pool_graph_masked, pool_operator)
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


def mnist_operators(graph: Graph, segment_ops: bool = False):
    """The operator set of a batch on its device, built on the host from
    its positions and precomputed clusters: ``conv1`` and ``conv2``, the
    spline operators of level 0 (the batch's ``edge_attr``) and of level 1
    (:func:`coarsened_levels`); ``pool1`` and ``pool2``, the
    ``cluster_operator`` s of ``cluster1`` over level 0 and of
    ``cluster2`` over level 1 (the means of ``pos``); ``readout``, level
    2's ``pool_operator``. ``segment_ops``: also ``segment1`` and
    ``segment2``, each level's ``SortedSegmentSum`` over its receivers
    (the relabelled ones at level 1), for NNConv's sums
    (examples/mnist_nn_conv.py)."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum

    dev = graph.device
    g0 = graph.to("cpu")
    g1, g2 = coarsened_levels(g0)
    ops = {"conv1": spline_operator(g0, DIM, KERNEL_SIZE, device=dev),
           "conv2": spline_operator(g1, DIM, KERNEL_SIZE, device=dev),
           "pool1": cluster_operator(g0.extras["cluster1"], g0, device=dev),
           "pool2": cluster_operator(g0.extras["cluster2"], g1, device=dev),
           "readout": pool_operator(g2, device=dev)}
    if segment_ops:
        for k, g in ((1, g0), (2, g1)):
            ops[f"segment{k}"] = SortedSegmentSum(g.receivers, g.num_nodes,
                                                  device=dev)
    return ops


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
    False; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model(graph, train=train, ops=ops, generator=generator),
                   graph)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: nn.Module, loader: DataLoader, ops: OperatorCache):
    """Accuracy of the argmax over the loader's real graphs."""
    correct = total = 0
    with torch.no_grad():
        for idx, graph in loader.indexed():
            pred = model(graph, ops=ops(idx, graph)).argmax(dim=1)
            m = graph.graph_mask
            correct += int(((pred == graph.y.long()) & m).sum())
            total += int(m.sum())
    return correct / max(total, 1)


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


def fit(model: nn.Module, loaders, epochs: int, seed: int, dev, build,
        lr: float = 0.01):
    """The scripts' loop: Adam ``lr``, dropout drawn from ``seed``, one
    operator set a distinct batch (``build``), the JAX line per epoch.
    Returns the last test accuracy, the mean loss of each epoch, every
    step's loss, the operator sets built, the host seconds their build
    took and the run's seconds."""
    train_loader, test_loader = loaders
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train_ops, test_ops = OperatorCache(build), OperatorCache(build)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph, train_ops(idx, graph), gen)
                  for idx, graph in train_loader.indexed()]
        acc = evaluate(model, test_loader, test_ops)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
              f"Test Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "operators": len(train_ops.ops) + len(test_ops.ops),
            "operator_seconds": train_ops.seconds + test_ops.seconds,
            "seconds": time.perf_counter() - t0}


def run(epochs: int = 3, batch_size: int = 64, seed: int = 0,
        train_samples: int = 1500, device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch; ``loaders``
    (train, test) replaces :func:`load`'s. Returns :func:`fit`'s
    record."""
    dev = resolve_device(device)
    loaders = loaders or load(seed, batch_size, train_samples, device=dev)
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    next(iter(loaders[0]))
    model = Net(generator=torch.Generator().manual_seed(seed)).to(dev)
    return fit(model, loaders, epochs, seed, dev, mnist_operators)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
