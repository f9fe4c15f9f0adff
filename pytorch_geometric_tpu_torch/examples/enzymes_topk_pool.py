"""TopK pooling on ENZYMES: the port's counterpart of
examples/enzymes_topk_pool.py. Three times GraphConv (hidden 128, ReLU)
then ``TopKPooling`` (ratio 0.8), each level read out as max ‖ mean and
the readouts summed; Dense 128 (ReLU, dropout 0.5), Dense 64 (ReLU),
Dense to 6 classes; the cross-entropy over the real graphs, Adam 5e-4,
batches of 64 shuffled from ``seed``, 20 epochs.

    python -m pytorch_geometric_tpu_torch.examples.enzymes_topk_pool

The pooled graphs keep the batch's shapes (``TopKPooling`` returns new
masks), so one operator set of the batch, built on the host
(``examples/mutag_gin.py:mutag_operators``, in an
``examples/ppi.py:OperatorCache``), serves all
three levels: the ``SpmmOperator`` of its edges, which every GraphConv
sum runs through (``spmm_csr``), each level's ``edge_mask`` going in as
the edge weight; and the readout's ``SortedSegmentSum`` over the batch
vector, through which each level's mean runs (the segment-sum kernel).
The max is torch's ``scatter_reduce``. Eager; prints the JAX script's
line per epoch.
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
from pytorch_geometric_tpu_torch.examples.mutag_gin import (
    loss_of, mutag_operators)
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.nn.conv import GraphConv
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.nn.pool import (
    TopKPooling, global_max_pool, global_mean_pool)

LEVELS = 3


class Net(nn.Module):
    """examples/enzymes_topk_pool.py's ``Net`` with its parameter names
    (``conv1`` .. ``conv3``, ``pool1`` .. ``pool3``, ``Dense_0`` ..
    ``Dense_2``)."""

    def __init__(self, in_channels: int, num_classes: int,
                 hidden: int = 128, generator=None):
        super().__init__()
        for i in range(LEVELS):
            setattr(self, f"conv{i + 1}", GraphConv(
                in_channels if i == 0 else hidden, hidden,
                generator=generator))
            setattr(self, f"pool{i + 1}", TopKPooling(
                hidden, ratio=0.8, generator=generator))
        self.Dense_0 = Dense(2 * hidden, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, hidden // 2, generator=generator)
        self.Dense_2 = Dense(hidden // 2, num_classes, generator=generator)

    def forward(self, graph: Graph, *, train: bool = False, spmm_op=None,
                pool_op=None, generator=None):
        x = graph.x
        summaries = []
        g = graph
        for i in range(LEVELS):
            x = torch.relu(getattr(self, f"conv{i + 1}")(
                g, x, spmm_op=spmm_op))
            g = g.replace(x=x)
            g, x, _ = getattr(self, f"pool{i + 1}")(g, x)
            summaries.append(torch.cat(
                [global_max_pool(x, g),
                 global_mean_pool(x, g, segment_op=pool_op)], dim=1))
        h = sum(summaries)
        h = torch.relu(self.Dense_0(h))
        h = dropout(h, 0.5, train, generator)
        h = torch.relu(self.Dense_1(h))
        return self.Dense_2(h)


def train_step(model: Net, opt, graph: Graph, ops, generator=None,
               train: bool = True):
    """One Adam step on one batch, with dropout unless ``train`` is
    False; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model(graph, train=train, generator=generator, **ops),
                   graph)
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


def load(seed: int = 0, batch_size: int = 64, root=PLANETOID_ROOT,
         device="cuda"):
    """``(train loader, test loader)`` of the JAX script: ENZYMES under
    ``root`` shuffled from ``seed``, the first tenth the test set."""
    ds = TUDataset(str(root), "ENZYMES").shuffle(seed=seed)
    n = len(ds)
    test_ds, train_ds = ds[: n // 10], ds[n // 10:]
    return (DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                       seed=seed, device=device),
            DataLoader(test_ds, batch_size=batch_size, device=device))


def run(epochs: int = 20, batch_size: int = 64, seed: int = 0,
        device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch; returns what
    examples/mutag_gin.py's ``run`` returns."""
    dev = resolve_device(device)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, 6,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4)
    drop = torch.Generator(device=dev).manual_seed(seed)
    train_ops = OperatorCache(mutag_operators)
    test_ops = OperatorCache(mutag_operators)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph, train_ops(idx, graph), drop)
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
    p.add_argument("--epochs", type=int, default=20)
    args = p.parse_args()
    run(args.epochs)
