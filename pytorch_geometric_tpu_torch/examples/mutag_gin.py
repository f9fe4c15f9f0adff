"""GIN on MUTAG graph classification: the port's counterpart of
examples/mutag_gin.py. Five ``GINConv`` layers, each over an MLP (Dense,
ReLU, Dense, ``MaskedBatchNorm``) with a trained eps, 7 -> 32 x 5, ReLU
after each; ``global_add_pool``; Dense 32 (ReLU) and Dense to 2 classes.
The logits include the padding graph's row, and the cross-entropy is
masked by ``graph_mask``. Adam 0.01, batches of 32 graphs shuffled from
``seed``, a 90/10 split of the shuffled dataset, 30 epochs, test accuracy
after each (the running statistics of the batch norms).

    python -m pytorch_geometric_tpu_torch.examples.mutag_gin [--epochs 30]

The JAX script jits its training step and its evaluation once over the
loaders' static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget (:func:`static_batch`: the
graph, a ``StaticSpmmOperator`` and the readout's ``StaticSegmentSum``).
Shuffled batches are new each epoch, so each batch's operator set is
built on the host (:func:`mutag_operators`, in an
``examples/ppi.py:OperatorCache``), staged in pinned memory and copied
in without a host wait before the replay; the test batch's is built
once. The operators hold the batch's real edges only: a padding edge has
weight 0, so every sum is bitwise the padded operator's, and the padding
node's row is no longer the thousands of entries one group of lanes
walks. Every GIN sum runs through the ``SpmmOperator`` (the ``spmm_csr``
kernel: 5 launches forward, 4 ``dx`` in the backward, none for conv1's
input), the readout through the ``SortedSegmentSum`` (the segment-sum
kernel: 1 launch; its backward is a gather). The batch norms' running
statistics update in place inside the training graph, and the
evaluation graph reads them. ``capture=False`` runs the same steps
eagerly over each batch's own tensors (the CPU's only mode). Prints the
JAX script's line per epoch.
"""

import argparse
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, StaticBatch, captured_metrics,
    resolve_capture, static_batches)
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import GINConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.norm import MaskedBatchNorm
from pytorch_geometric_tpu_torch.nn.pool import global_add_pool, pool_operator
from pytorch_geometric_tpu_torch.ops.sorted_spmm import StaticSegmentSum
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, StaticSpmmOperator)

LAYERS = 5
#: The flax names of the JAX script's MLPs (adopted by its ``Net``) and
#: the port's, for ``convert.params_from_jax(..., names=FLAX_NAMES)``.
FLAX_NAMES = {f"MLP_{i}": f"conv{i + 1}.mlp" for i in range(LAYERS)}


class MLP(nn.Module):
    """examples/mutag_gin.py's ``MLP``: Dense, ReLU, Dense, masked batch
    norm."""

    def __init__(self, in_channels: int, hidden: int, generator=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, hidden, generator=generator)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(hidden)

    def forward(self, x, mask=None, train: bool = False):
        x = torch.relu(self.Dense_0(x))
        x = self.Dense_1(x)
        return self.MaskedBatchNorm_0(x, mask, train=train)


class Net(nn.Module):
    """examples/mutag_gin.py's ``Net``: ``conv1`` .. ``conv5`` (their MLPs
    are the JAX ``MLP_0`` .. ``MLP_4``, :data:`FLAX_NAMES`), ``Dense_0``,
    ``Dense_1``."""

    def __init__(self, in_channels: int = 7, hidden: int = 32,
                 num_classes: int = 2, generator=None):
        super().__init__()
        for i in range(LAYERS):
            setattr(self, f"conv{i + 1}", GINConv(
                MLP(in_channels if i == 0 else hidden, hidden, generator),
                train_eps=True))
        self.Dense_0 = Dense(hidden, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, num_classes, generator=generator)

    def forward(self, graph: Graph, *, train: bool = False, spmm_op=None,
                pool_op=None):
        x = graph.x
        for i in range(LAYERS):
            conv = getattr(self, f"conv{i + 1}")
            x = torch.relu(conv(graph, x, train=train, spmm_op=spmm_op))
        hg = global_add_pool(x, graph, segment_op=pool_op)
        hg = torch.relu(self.Dense_0(hg))
        return self.Dense_1(hg)


def mutag_operators(graph: Graph):
    """``{"spmm_op", "pool_op"}`` of a batch on its device, built on the
    host: the ``SpmmOperator`` of its real edges (``edge_mask``; a padding
    edge's weight is 0, so every row's sum is the padded operator's) and
    the readout's ``SortedSegmentSum`` over its batch vector."""
    return {"spmm_op": SpmmOperator(graph.senders, graph.receivers,
                                    graph.num_nodes,
                                    edge_mask=graph.real_edge_mask(),
                                    device=graph.device),
            "pool_op": pool_operator(graph)}


def static_batch(loader: DataLoader, device) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph,
    a ``StaticSpmmOperator`` of its edge budget (``spmm_op``) and the
    readout's ``StaticSegmentSum``, a node an entry (``pool_op``)."""
    return StaticBatch(loader, {
        "spmm_op": StaticSpmmOperator(loader.num_nodes, loader.num_edges,
                                      device=device),
        "pool_op": StaticSegmentSum(loader.num_graphs, loader.num_nodes,
                                    device=device)}, device)


def loss_of(logits, graph: Graph):
    """The JAX script's loss: cross-entropy over the real graphs."""
    return graph_xent_loss(logits, graph.y, graph.graph_mask)


def train_step(model: Net, opt, graph: Graph, ops):
    """One Adam step on one batch (batch norms on their batch moments,
    running statistics updated), the gradients zeroed in place (a
    captured step keeps them); the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model(graph, train=True, **ops), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def accuracy_of(pairs):
    """Accuracy of the argmax over the real graphs of ``(batch, logits)``
    pairs."""
    correct = total = 0
    for graph, logits in pairs:
        pred = logits.argmax(dim=1).to(graph.y.device)
        m = graph.graph_mask
        correct += int(((pred == graph.y.long()) & m).sum())
        total += int(m.sum())
    return correct / max(total, 1)


def evaluate(model: Net, loader: DataLoader, ops: OperatorCache):
    """Accuracy of the argmax over the loader's real graphs."""
    with torch.no_grad():
        return accuracy_of((graph, model(graph, **ops(idx, graph)))
                           for idx, graph in loader.indexed())


def captured_steps(model: Net, opt, train_loader: DataLoader,
                   test_loader: DataLoader, steps: int, dev):
    """``(train, test, step, predict, curve)``: the static batches of both
    loaders, the training step over ``train`` (its loss into the next row
    of ``curve``, a :class:`DeviceCurve` of ``steps`` rows) and the
    evaluation's logits over ``test``, each a :class:`CapturedStep`."""
    train = static_batch(train_loader, dev)
    test = static_batch(test_loader, dev)
    curve = DeviceCurve(steps, 1, dev)
    step = CapturedStep(lambda: curve.record(train_step(
        model, opt, train.graph, train.ops)), dev)

    def logits():
        with torch.no_grad():
            return model(test.graph, **test.ops)

    return train, test, step, CapturedStep(logits, dev), curve


def load(seed: int = 0, batch_size: int = 32, root=PLANETOID_ROOT,
         device="cuda"):
    """``(train loader, test loader)`` of the JAX script: MUTAG under
    ``root`` shuffled from ``seed``, the first tenth the test set, the
    train loader shuffled from ``seed``."""
    dataset = TUDataset(str(root), "MUTAG").shuffle(seed=seed)
    n = len(dataset)
    test_ds = dataset[: n // 10]
    train_ds = dataset[n // 10:]
    return (DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                       seed=seed, device=device),
            DataLoader(test_ds, batch_size=batch_size, device=device))


def run(epochs: int = 30, batch_size: int = 32, seed: int = 0,
        device="cuda", loaders=None, capture=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test) replaces :func:`load`'s. ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU; True
    elsewhere than a card raises. Returns the last test accuracy, the
    mean loss of each epoch, every step's loss, the operator sets built,
    the host seconds their build took, the run's seconds and the model; a
    captured run adds what ``models/capture.py:captured_metrics``
    gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, 32, 2,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.01,
                           capturable=dev.type == "cuda")
    if capture:
        # the batches come collated on the host, and so do their
        # operators, copied in through pinned memory
        train, test, step, predict, curve = captured_steps(
            model, opt, train_loader, test_loader,
            epochs * len(train_loader), dev)
        host = {}
    train_ops = OperatorCache(mutag_operators)
    test_ops = OperatorCache(mutag_operators)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        if capture:
            for _ in static_batches(train_loader, train_ops, train, host):
                step()
            acc = accuracy_of((graph, predict()) for graph in
                              static_batches(test_loader, test_ops, test,
                                             host))
            n = len(train_loader)
            losses = curve.host((epoch - 1) * n, epoch * n)[:, 0]
        else:
            losses = [train_step(model, opt, graph, train_ops(idx, graph))
                      for idx, graph in train_loader.indexed()]
            acc = evaluate(model, test_loader, test_ops)
            losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:03d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {acc:.4f}")
    out = {"acc": acc, "epoch_losses": epoch_losses,
           "step_losses": np.stack(step_losses),
           "operators": len(train_ops.ops) + len(test_ops.ops),
           "operator_seconds": train_ops.seconds + test_ops.seconds,
           "seconds": time.perf_counter() - t0, "model": model}
    if capture:
        out.update(captured_metrics(
            {"train": step, "evaluation": predict}, host))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=32)
    args = p.parse_args()
    run(args.epochs, args.batch_size)
