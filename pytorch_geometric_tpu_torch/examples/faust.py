"""SplineConv shape correspondence on FAUST: the port's counterpart of
examples/faust.py. Each mesh's faces become undirected edges
(``FaceToEdge``) with Cartesian pseudo-coordinates (``Cartesian``); six
``SplineConv(dim=3, kernel_size=5)`` layers, 1 -> 32 -> 64 x 5, each with
an ELU, then Dense 256 (ELU, dropout 0.5) and Dense to one class per
vertex; the masked NLL of each vertex's own id, Adam 1e-2, batches of one
mesh shuffled from ``seed``, test accuracy after each epoch.

    python -m pytorch_geometric_tpu_torch.examples.faust [--epochs 3]

The JAX script sums each layer's (N·K, F) accumulator (K = 5^3 = 125
kernel weights) with a segment sum over the fused id ``receiver·K +
kernel index``. Here that accumulator is one rectangular SpMM of the
batch's mesh (``nn/conv/spline_conv.py:spline_operator``): one
``spmm_csr`` launch a layer forward and one for its ``dx`` (none for
conv1, whose input takes no gradient). The pseudo-coordinates, and so the
operator, are the mesh's: it is built on the host once per distinct batch
and kept on the run's device (``examples/ppi.py:OperatorCache``).

The JAX script jits its training step and its evaluation once over the
loaders' static budget. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget (:func:`static_batch`: the
graph and a ``static_spline_operator``, a slot for each of an edge's
eight corners). Each batch is collated on the host and copied in, its
cached operator device to device, then the graph replays; the dropout
draws from the run's CUDA generator, which the training graph registers,
and Adam keeps its step count on the card. Each step's loss and each test
batch's correct and total counts stay in device buffers until the epoch
ends (``models/capture.py:StepLoop``). ``capture=False`` runs the same
steps eagerly over each batch's own tensors (the CPU's only mode).
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
from pytorch_geometric_tpu_torch.datasets import FAUST
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.models.capture import (
    StaticBatch, StepLoop, resolve_capture)
from pytorch_geometric_tpu_torch.nn.conv import (
    SplineConv, spline_operator, static_spline_operator)
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.transforms import (
    Cartesian, Compose, FaceToEdge)

#: The six SplineConv layers' output widths (the input is one channel).
WIDTHS = (32, 64, 64, 64, 64, 64)
DIM, KERNEL_SIZE = 3, 5


class Net(nn.Module):
    """examples/faust.py's ``Net``, with its parameter names (``conv1``
    .. ``conv6``, ``Dense_0``, ``Dense_1``), so that
    ``convert.params_from_jax`` carries the flax parameters across."""

    def __init__(self, num_vertices: int, generator=None):
        super().__init__()
        for i, (c_in, c_out) in enumerate(zip((1,) + WIDTHS[:-1], WIDTHS)):
            setattr(self, f"conv{i + 1}",
                    SplineConv(c_in, c_out, dim=DIM, kernel_size=KERNEL_SIZE,
                               generator=generator))
        self.Dense_0 = Dense(WIDTHS[-1], 256, generator=generator)
        self.Dense_1 = Dense(256, num_vertices, generator=generator)

    def forward(self, graph: Graph, *, train: bool = False, spline_op=None,
                generator=None):
        x = torch.ones((graph.num_nodes, 1), device=graph.device)
        for i in range(len(WIDTHS)):
            conv = getattr(self, f"conv{i + 1}")
            x = F.elu(conv(graph, x, spline_op=spline_op))
        x = F.elu(self.Dense_0(x))
        x = dropout(x, 0.5, train, generator)
        return self.Dense_1(x)


def faust_spline_op(graph: Graph, device=None):
    """The batch's rectangular spline operator (fp32) on ``device``
    (default: the graph's): the (N·K, N) accumulator of every layer,
    built on the host from a CPU copy of the batch, so that a batch
    collated on the card and the same batch collated on the host give the
    same operator."""
    dev = graph.device if device is None else device
    return spline_operator(graph.to("cpu"), DIM, KERNEL_SIZE, device=dev)


def static_batch(loader: DataLoader, device) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph
    and a ``static_spline_operator`` (``spline_op``) of its node and edge
    budgets, which every batch's :func:`faust_spline_op` fits."""
    return StaticBatch(loader, {"spline_op": static_spline_operator(
        loader.num_nodes, loader.num_edges, DIM, KERNEL_SIZE,
        device=device)}, device)


def nll_loss(logits, graph: Graph):
    """Negative log-likelihood of each real vertex's id, summed and
    divided by their count (at least 1), as the JAX script's loss."""
    nll = -F.log_softmax(logits, dim=1).gather(
        1, graph.y.long()[:, None])[:, 0]
    m = graph.node_mask.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def train_step(model: Net, opt, graph: Graph, op, generator=None,
               train: bool = True):
    """One Adam step on one batch, with dropout unless ``train`` is
    False, the gradients zeroed in place (a captured step keeps them);
    the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = nll_loss(model(graph, train=train, spline_op=op,
                          generator=generator), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def counts_of(model: Net, graph: Graph, op):
    """``(correct, total)`` of the argmax over the batch's real vertices,
    as device scalars (the JAX script's ``eval_step``)."""
    with torch.no_grad():
        pred = model(graph, spline_op=op).argmax(dim=1)
    m = graph.node_mask
    return ((pred == graph.y.long()) & m).sum(), m.sum()


def step_loop(model: Net, opt, loaders, epochs: int, dev, generator,
              capture: bool = False) -> StepLoop:
    """The run's :class:`StepLoop`: the training step (dropout from
    ``generator``) and the evaluation over each batch's cached operator
    (one ``OperatorCache`` a loader, built on the host and kept on
    ``dev``), captured over :func:`static_batch` es of both loaders if
    ``capture``."""
    def build(graph):
        return {"spline_op": faust_spline_op(graph, dev)}

    statics = tuple(static_batch(loader, dev) for loader in loaders) \
        if capture else None
    return StepLoop(
        loaders, (OperatorCache(build), OperatorCache(build)),
        lambda graph, ops: train_step(model, opt, graph, ops["spline_op"],
                                      generator),
        lambda graph, ops: counts_of(model, graph, ops["spline_op"]),
        epochs, dev, capture, statics, generator)


def load(seed: int = 0, num_vertices: int = 684, root=PLANETOID_ROOT,
         device="cuda"):
    """``(train loader, test loader)`` of the JAX script: FAUST under
    ``root`` through ``Compose([FaceToEdge(), Cartesian()])``, batches of
    1, the train loader shuffled from ``seed``."""
    pre = Compose([FaceToEdge(), Cartesian()])
    train_ds = FAUST(str(root), train=True, pre_transform=pre,
                     num_vertices=num_vertices)
    test_ds = FAUST(str(root), train=False, pre_transform=pre,
                    num_vertices=num_vertices)
    return (DataLoader(train_ds, batch_size=1, shuffle=True, seed=seed,
                       device=device),
            DataLoader(test_ds, batch_size=1, device=device))


def run(epochs: int = 3, seed: int = 0, num_vertices: int = 684,
        device="cuda", loaders=None, capture=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test) replaces :func:`load`'s. ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU; True
    elsewhere than a card raises. Returns the last test accuracy, the
    mean loss of each epoch, every step's loss, the operators built, the
    host seconds their build took, the run's seconds and the model; a
    captured run adds what ``models/capture.py:captured_metrics``
    gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    loaders = loaders or load(seed, num_vertices, device=dev)
    nv = loaders[0].dataset[0].num_nodes
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    next(iter(loaders[0]))
    model = Net(nv, generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2,
                           capturable=dev.type == "cuda")
    drop = torch.Generator(device=dev).manual_seed(seed)
    loop = step_loop(model, opt, loaders, epochs, dev, drop, capture)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses, (correct, total) = loop.epoch()
        acc = correct / max(total, 1.0)
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {acc:.4f}")
    train_ops, test_ops = loop.operators
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "operators": len(train_ops.ops) + len(test_ops.ops),
            "operator_seconds": train_ops.seconds + test_ops.seconds,
            "seconds": time.perf_counter() - t0, "model": model,
            **loop.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
