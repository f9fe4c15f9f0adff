"""MPNN (NNConv + GRU + Set2Set) on QM9 target 0: the port's counterpart
of examples/qm9_nn_conv.py. Each molecule's complete directed graph
(``Complete``, the JAX script's transform, copied) with its bond types
and distances (``Distance(norm=False)``); Dense 64 (ReLU); one
edge-conditioned ``NNConv`` (an edge MLP 5 -> 128 -> 64 x 64, mean
aggregation, root weight) and a ``GRUCell`` applied three times;
``Set2Set`` (3 steps); Dense 64 (ReLU) and Dense 1. The squared error of
the normalised target over the real graphs, Adam 1e-3, batches of 32
shuffled from ``seed`` over 1000 synthetic molecules (the train 80%),
5 epochs, the test MAE after each.

    python -m pytorch_geometric_tpu_torch.examples.qm9_nn_conv

Through one operator set of the batch, built on the host
(:func:`qm9_operators`, ``examples/ppi.py:OperatorCache``): NNConv's
messages are built per edge and summed by the ``SortedSegmentSum`` over
the batch's receivers, and Set2Set's softmax sums and readout by the one
over its batch vector: the segment-sum kernel on a card. Eager; prints
the JAX script's line per epoch.
"""

import argparse
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import DataLoader
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import QM9
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.nn.conv import NNConv
from pytorch_geometric_tpu_torch.nn.layers import Dense, gru_cell
from pytorch_geometric_tpu_torch.nn.pool import Set2Set, pool_operator
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum
from pytorch_geometric_tpu_torch.transforms import Compose, Distance
from pytorch_geometric_tpu_torch.utils.loop import remove_self_loops

#: The JAX script's edge MLP is adopted by its ``Net`` as ``EdgeNN_0``;
#: the port's sits in its conv (``convert.params_from_jax(...,
#: names=FLAX_NAMES)``).
FLAX_NAMES = {"EdgeNN_0": "NNConv_0.edge_nn"}


class Complete:
    """Dense edge set transform (reference qm9_nn_conv.py:24-47)."""

    def __call__(self, data):
        n = data.num_nodes
        row = np.repeat(np.arange(n), n)
        col = np.tile(np.arange(n), n)
        ea = None
        if data.edge_attr is not None:
            e = data.edge_attr
            ea = np.zeros((n * n,) + e.shape[1:], dtype=e.dtype)
            idx = data.edge_index[0] * n + data.edge_index[1]
            ea[idx] = e
        s, r, ea = remove_self_loops(row, col, ea)
        data.edge_index = np.stack([s, r])
        data.edge_attr = ea
        return data


class EdgeNN(nn.Module):
    """The edge MLP: Dense 128 (ReLU), Dense dim x dim."""

    def __init__(self, edge_channels: int, dim: int, generator=None):
        super().__init__()
        self.Dense_0 = Dense(edge_channels, 128, generator=generator)
        self.Dense_1 = Dense(128, dim * dim, generator=generator)

    def forward(self, ea):
        return self.Dense_1(torch.relu(self.Dense_0(ea)))


class Net(nn.Module):
    """examples/qm9_nn_conv.py's ``Net`` with flax's names (``Dense_0``,
    ``NNConv_0``, ``GRUCell_0``, ``Set2Set_0``, ``Dense_1``,
    ``Dense_2``)."""

    def __init__(self, in_channels: int = 5, edge_channels: int = 5,
                 dim: int = 64, generator=None):
        super().__init__()
        self.Dense_0 = Dense(in_channels, dim, generator=generator)
        self.NNConv_0 = NNConv(dim, dim, EdgeNN(edge_channels, dim,
                                                generator),
                               aggr="mean", root_weight=True,
                               generator=generator)
        self.GRUCell_0 = gru_cell(dim, dim, generator)
        self.Set2Set_0 = Set2Set(dim, processing_steps=3,
                                 generator=generator)
        self.Dense_1 = Dense(2 * dim, dim, generator=generator)
        self.Dense_2 = Dense(dim, 1, generator=generator)

    def forward(self, graph: Graph, *, segment_op=None, pool_op=None):
        h = torch.relu(self.Dense_0(graph.x))
        for _ in range(3):
            m = torch.relu(self.NNConv_0(graph, h, segment_op=segment_op))
            h = self.GRUCell_0(m, h)
        out = self.Set2Set_0(h, graph, segment_op=pool_op)
        out = torch.relu(self.Dense_1(out))
        return self.Dense_2(out)[:, 0]


def qm9_operators(graph: Graph):
    """``{"segment_op", "pool_op"}`` of a batch on its device: the
    ``SortedSegmentSum`` over its receivers (NNConv's messages) and over
    its batch vector (Set2Set)."""
    return {"segment_op": SortedSegmentSum(graph.receivers,
                                           graph.num_nodes,
                                           device=graph.device),
            "pool_op": pool_operator(graph)}


def loss_of(pred, graph: Graph, mean: float, std: float):
    """The JAX script's loss: the squared error of the normalised target
    over the real graphs."""
    target = (graph.y[:, 0] - mean) / (std + 1e-12)
    m = graph.graph_mask.to(torch.float32)
    return (((pred - target) ** 2) * m).sum() / m.sum().clamp_min(1.0)


def train_step(model: Net, opt, graph: Graph, ops, mean: float,
               std: float):
    """One Adam step on one batch; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model(graph, **ops), graph, mean, std)
    loss.backward()
    opt.step()
    return loss.detach()


def load(seed: int = 0, batch_size: int = 32, num_samples: int = 1000,
         root=PLANETOID_ROOT, device="cuda"):
    """``(train loader, test loader, mean, std)`` of the JAX script: the
    target 0's mean and standard deviation over the whole corpus."""
    ds = QM9(str(root), transform=Compose([Complete(),
                                           Distance(norm=False)]),
             num_synthetic=num_samples)
    ys = np.stack([ds.data_list[i].y[0] for i in range(len(ds))])
    mean, std = ys[:, 0].mean(), ys[:, 0].std()
    n = len(ds)
    sh = ds.shuffle(seed=seed)
    test_ds, train_ds = sh[: n // 10], sh[n // 5:]
    return (DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                       seed=seed, device=device),
            DataLoader(test_ds, batch_size=batch_size, device=device),
            float(mean), float(std))


def run(epochs: int = 5, batch_size: int = 32, seed: int = 0,
        num_samples: int = 1000, device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test, mean, std) replaces :func:`load`'s. Returns the last
    test MAE, the mean loss of each epoch, every step's loss, the
    operator sets built, the host seconds their build took and the run's
    seconds."""
    dev = resolve_device(device)
    train_loader, test_loader, mean, std = loaders or load(
        seed, batch_size, num_samples, device=dev)
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, g0.num_edge_features,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    train_ops = OperatorCache(qm9_operators)
    test_ops = OperatorCache(qm9_operators)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph, train_ops(idx, graph), mean,
                             std)
                  for idx, graph in train_loader.indexed()]
        tot = cnt = 0.0
        with torch.no_grad():
            for idx, graph in test_loader.indexed():
                pred = model(graph, **test_ops(idx, graph)) * \
                    (std + 1e-12) + mean
                m = graph.graph_mask.to(torch.float32)
                tot += float(((pred - graph.y[:, 0]).abs() * m).sum())
                cnt += float(m.sum())
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test MAE: {tot / max(cnt, 1):.4f}")
    return {"mae": tot / max(cnt, 1), "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "operators": len(train_ops.ops) + len(test_ops.ops),
            "operator_seconds": train_ops.seconds + test_ops.seconds,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    args = p.parse_args()
    run(args.epochs)
