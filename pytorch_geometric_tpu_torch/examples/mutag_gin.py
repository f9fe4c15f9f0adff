"""GIN on MUTAG graph classification: the port's counterpart of
examples/mutag_gin.py. Five ``GINConv`` layers, each over an MLP (Dense,
ReLU, Dense, ``MaskedBatchNorm``) with a trained eps, 7 -> 32 x 5, ReLU
after each; ``global_add_pool``; Dense 32 (ReLU) and Dense to 2 classes.
The logits include the padding graph's row, and the cross-entropy is
masked by ``graph_mask``. Adam 0.01, batches of 32 graphs shuffled from
``seed``, a 90/10 split of the shuffled dataset, 30 epochs, test accuracy
after each (the running statistics of the batch norms).

    python -m pytorch_geometric_tpu_torch.examples.mutag_gin [--epochs 30]

The JAX script jits one step over each collated batch. Here the step runs
eagerly over one operator set of the batch, built on the host
(:func:`mutag_operators`, keyed by the batch's dataset indices in an
``examples/ppi.py:OperatorCache``): the ``SpmmOperator`` of its edges,
through which every GIN sum runs (the ``spmm_csr`` kernel: 5 launches
forward, 4 ``dx`` in the backward, none for conv1's input), and the
readout's ``SortedSegmentSum`` over its batch vector (the segment-sum
kernel: 1 launch; its backward is a gather). Shuffled batches are new
each epoch, so the train operators are built anew every epoch; the test
batch's once. Prints the JAX script's line per epoch.
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
from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
from pytorch_geometric_tpu_torch.nn.conv import GINConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.norm import MaskedBatchNorm
from pytorch_geometric_tpu_torch.nn.pool import global_add_pool, pool_operator
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

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
    """``{"spmm_op", "pool_op"}`` of a batch on its device: the
    ``SpmmOperator`` of its edges (padding edges included, weight 0) and
    the readout's ``SortedSegmentSum`` over its batch vector."""
    return {"spmm_op": SpmmOperator(graph.senders, graph.receivers,
                                    graph.num_nodes, device=graph.device),
            "pool_op": pool_operator(graph)}


def loss_of(logits, graph: Graph):
    """The JAX script's loss: cross-entropy over the real graphs."""
    return graph_xent_loss(logits, graph.y, graph.graph_mask)


def train_step(model: Net, opt, graph: Graph, ops):
    """One Adam step on one batch (batch norms on their batch moments,
    running statistics updated); the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model(graph, train=True, **ops), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: Net, loader: DataLoader, ops: OperatorCache):
    """Accuracy of the argmax over the loader's real graphs."""
    correct = total = 0
    with torch.no_grad():
        for idx, graph in loader.indexed():
            pred = model(graph, **ops(idx, graph)).argmax(dim=1)
            m = graph.graph_mask
            correct += int(((pred == graph.y.long()) & m).sum())
            total += int(m.sum())
    return correct / max(total, 1)


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
        device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test) replaces :func:`load`'s. Returns the last test
    accuracy, the mean loss of each epoch, every step's loss, the
    operator sets built, the host seconds their build took and the run's
    seconds."""
    dev = resolve_device(device)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, 32, 2,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    train_ops = OperatorCache(mutag_operators)
    test_ops = OperatorCache(mutag_operators)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph, train_ops(idx, graph))
                  for idx, graph in train_loader.indexed()]
        acc = evaluate(model, test_loader, test_ops)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:03d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "operators": len(train_ops.ops) + len(test_ops.ops),
            "operator_seconds": train_ops.seconds + test_ops.seconds,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=32)
    args = p.parse_args()
    run(args.epochs, args.batch_size)
