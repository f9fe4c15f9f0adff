"""GAT on PPI (inductive multi-label node classification): the port's
counterpart of examples/ppi.py. Three GAT layers, 50 -> 4 x 256 -> 4 x
256 (+ a Dense skip) -> 6 x 121 averaged (+ a Dense skip), sigmoid
binary cross-entropy over the real nodes, Adam 5e-3, batches of one
graph over the 20 train graphs (shuffled each epoch, as the JAX loader
shuffles), micro-F1 on the 2 val graphs in one batch.

    python -m pytorch_geometric_tpu_torch.examples.ppi [--epochs 10]

The JAX script runs ``GATConv``'s sparse segment-softmax path on each
batch. On the card no layer sums feature rows with plain segment ops:
every attention layer goes through one ``PackedFlashGat`` of the batch's
graph, over ``gat_sparse_edge_set`` (the sparse path's softmax slots:
repeated edges kept, existing self loops dropped, one loop a node), so
it computes the sparse path's function. The operator is built on the
host once per distinct batch, keyed by the batch's dataset indices, and
reused in every epoch (:class:`OperatorCache`).

The JAX script jits its training step and its prediction once over the
loaders' static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``):
the train batches (3,072 nodes) and the val batch (6,144) each have
static buffers (:func:`static_batch`: the graph and a
``StaticPackedFlashGat`` of the edge budget plus a loop a node). Each
batch is collated on the host and copied in, its cached operator's CSRs
device to device, then the graph replays; the losses stay on the card
until the epoch ends. ``capture=False`` runs the same steps eagerly over
each batch's own tensors (the CPU's only mode). Prints the JAX script's
line per epoch.
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
from pytorch_geometric_tpu_torch.datasets import PPI
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, StaticBatch, captured_metrics,
    resolve_capture, static_batches)
from pytorch_geometric_tpu_torch.nn.conv import GATConv, gat_sparse_edge_set
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.ops.packed_gat import (
    PackedFlashGat, StaticPackedFlashGat)


class Net(nn.Module):
    """examples/ppi.py's ``Net``, with its parameter names (``conv1``,
    ``conv2``, ``lin2``, ``conv3``, ``lin3``), so that
    ``convert.params_from_jax`` carries the flax parameters across."""

    def __init__(self, in_channels: int = 50, num_classes: int = 121,
                 generator=None):
        super().__init__()
        self.conv1 = GATConv(in_channels, 256, heads=4, generator=generator)
        self.conv2 = GATConv(4 * 256, 256, heads=4, generator=generator)
        self.lin2 = Dense(4 * 256, 4 * 256, generator=generator)
        self.conv3 = GATConv(4 * 256, num_classes, heads=6, concat=False,
                             generator=generator)
        self.lin3 = Dense(4 * 256, num_classes, generator=generator)

    def forward(self, graph: Graph, x, *, flash_op=None):
        h = self.conv1(graph, x, flash_op=flash_op)
        x = F.elu(h)
        h = self.conv2(graph, x, flash_op=flash_op)
        x = F.elu(h + self.lin2(x))
        return self.conv3(graph, x, flash_op=flash_op) + self.lin3(x)


def micro_f1(pred, y, mask):
    pred = pred[mask]
    y = y[mask]
    tp = float(np.sum(pred * y))
    fp = float(np.sum(pred * (1 - y)))
    fn = float(np.sum((1 - pred) * y))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def ppi_flash_op(graph: Graph, device=None) -> PackedFlashGat:
    """The batch's fused attention operator, on ``device`` (default: the
    graph's)."""
    senders, receivers = gat_sparse_edge_set(graph)
    return PackedFlashGat(senders=senders, receivers=receivers,
                          num_nodes=graph.num_nodes,
                          device=graph.device if device is None else device)


def static_batch(loader: DataLoader, device) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph
    and a ``StaticPackedFlashGat`` (``flash_op``) of the edge budget plus
    a self loop a node, which every batch's operator fits."""
    return StaticBatch(loader, {"flash_op": StaticPackedFlashGat(
        loader.num_nodes, loader.num_edges + loader.num_nodes,
        device=device)}, device)


class OperatorCache:
    """One operator per distinct batch of a loader, keyed by the batch's
    dataset indices: ``build(graph)`` (:func:`ppi_flash_op` by default)
    on a batch's first sight; ``seconds`` is the host time spent
    building them."""

    def __init__(self, build=None):
        self.build = build or ppi_flash_op
        self.ops = {}
        self.seconds = 0.0

    def __call__(self, indices, graph: Graph):
        key = tuple(int(i) for i in indices)
        if key not in self.ops:
            t0 = time.perf_counter()
            self.ops[key] = self.build(graph)
            self.seconds += time.perf_counter() - t0
        return self.ops[key]


def bce_loss(logits, graph: Graph):
    """Sigmoid cross-entropy summed over the real nodes' labels and
    divided by their count (at least 1), as the JAX script's loss."""
    bce = F.binary_cross_entropy_with_logits(logits, graph.y,
                                             reduction="none")
    m = graph.node_mask.float()[:, None]
    return (bce * m).sum() / (m.sum() * graph.y.shape[1]).clamp_min(1.0)


def train_step(model: Net, opt, graph: Graph, op):
    """One Adam step on one batch, the gradients zeroed in place (a
    captured step keeps them); the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = bce_loss(model(graph, graph.x, flash_op=op), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def f1_of(pairs):
    """Micro-F1 of ``logits > 0`` over the real nodes of ``(batch,
    logits)`` pairs."""
    preds, ys, masks = [], [], []
    for graph, logits in pairs:
        preds.append((logits > 0).float().cpu().numpy())
        ys.append(graph.y.cpu().numpy())
        masks.append(graph.node_mask.cpu().numpy())
    return micro_f1(np.concatenate(preds), np.concatenate(ys),
                    np.concatenate(masks))


def evaluate(model: Net, loader: DataLoader, ops: OperatorCache):
    """Micro-F1 of ``logits > 0`` over the loader's real nodes."""
    with torch.no_grad():
        return f1_of((graph, model(graph, graph.x, flash_op=ops(idx, graph)))
                     for idx, graph in loader.indexed())


def captured_steps(model: Net, opt, train_loader: DataLoader,
                   val_loader: DataLoader, steps: int, dev):
    """``(train, val, step, predict, curve)``: the static batches of both
    loaders, the training step over ``train`` (its loss into the next row
    of ``curve``, a :class:`DeviceCurve` of ``steps`` rows) and the
    prediction over ``val``, each a :class:`CapturedStep`."""
    train, val = static_batch(train_loader, dev), static_batch(val_loader,
                                                               dev)
    curve = DeviceCurve(steps, 1, dev)
    step = CapturedStep(lambda: curve.record(train_step(
        model, opt, train.graph, train.ops["flash_op"])), dev)

    def logits():
        with torch.no_grad():
            return model(val.graph, val.graph.x, flash_op=val.ops["flash_op"])

    return train, val, step, CapturedStep(logits, dev), curve


def load(seed: int = 0, root=PLANETOID_ROOT, device="cuda"):
    """``(train loader, val loader)`` of the JAX script: PPI under
    ``root`` (``datasets_cache/``), batches of 1 shuffled from ``seed``,
    the val graphs in one batch of 2."""
    train_loader = DataLoader(PPI(str(root), "train"), batch_size=1,
                              shuffle=True, seed=seed, device=device)
    val_loader = DataLoader(PPI(str(root), "val"), batch_size=2,
                            device=device)
    return train_loader, val_loader


def run(epochs: int = 10, seed: int = 0, device="cuda", loaders=None,
        capture=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, val) replaces :func:`load`'s. ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU; True
    elsewhere than a card raises. Returns the last val F1, the mean loss
    of each epoch, every step's loss, the operators built, the host
    seconds their build took, the run's seconds and the model; a captured
    run adds what ``models/capture.py:captured_metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    train_loader, val_loader = loaders or load(seed, device=dev)
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, g0.y.shape[1],
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3,
                           capturable=dev.type == "cuda")
    if capture:
        # one operator a distinct batch, kept on the card
        build = functools.partial(ppi_flash_op, device=dev)
        train_ops = OperatorCache(lambda g: {"flash_op": build(g)})
        val_ops = OperatorCache(lambda g: {"flash_op": build(g)})
        train, val, step, predict, curve = captured_steps(
            model, opt, train_loader, val_loader,
            epochs * len(train_loader), dev)
        host = {}
    else:
        train_ops, val_ops = OperatorCache(), OperatorCache()
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        if capture:
            for _ in static_batches(train_loader, train_ops, train, host):
                step()
            f1 = f1_of((graph, predict()) for graph in static_batches(
                val_loader, val_ops, val, host))
            n = len(train_loader)
            losses = curve.host((epoch - 1) * n, epoch * n)[:, 0]
        else:
            losses = [train_step(model, opt, graph, train_ops(idx, graph))
                      for idx, graph in train_loader.indexed()]
            f1 = evaluate(model, val_loader, val_ops)
            losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Val F1: {f1:.4f}")
    out = {"f1": f1, "epoch_losses": epoch_losses,
           "step_losses": np.stack(step_losses),
           "operators": len(train_ops.ops) + len(val_ops.ops),
           "operator_seconds": train_ops.seconds + val_ops.seconds,
           "seconds": time.perf_counter() - t0, "model": model}
    if capture:
        out.update(captured_metrics(
            {"train": step, "evaluation": predict}, host))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=10)
    args = p.parse_args()
    run(args.epochs)
