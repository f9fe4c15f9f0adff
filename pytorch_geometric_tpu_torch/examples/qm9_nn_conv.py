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

The JAX script jits its training step and its MAE once over the
loaders' static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget (:func:`static_batch`). Each
batch's operator set (:func:`qm9_operators`), built on the host in an
``examples/ppi.py:OperatorCache``, is staged in pinned memory and copied
in without a host wait before the replay: NNConv's messages are built
per edge and summed by the ``SortedSegmentSum`` over the batch's
receivers and real edges (the padding edges' row holds no entry), its
input gathered by the one over the senders (the gradient then sums in
the segment-sum kernel, in a fixed order), and Set2Set's softmax sums
and readout by the one over the batch vector's real nodes. Each step's
loss and each test batch's summed absolute error and graph count are
written into device buffers, which the host reads once an epoch.
``capture=False`` runs the same steps eagerly over each batch's own
tensors (the CPU's only mode). Prints the JAX script's line per epoch.
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
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, StaticBatch, captured_metrics,
    resolve_capture, static_batches)
from pytorch_geometric_tpu_torch.nn.conv import NNConv
from pytorch_geometric_tpu_torch.nn.layers import Dense, gru_cell
from pytorch_geometric_tpu_torch.nn.pool import Set2Set, pool_operator
from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
    SortedSegmentSum, StaticSegmentSum)
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

    def forward(self, graph: Graph, *, segment_op=None, pool_op=None,
                sender_op=None):
        h = torch.relu(self.Dense_0(graph.x))
        for _ in range(3):
            m = torch.relu(self.NNConv_0(graph, h, segment_op=segment_op,
                                         sender_op=sender_op))
            h = self.GRUCell_0(m, h)
        out = self.Set2Set_0(h, graph, segment_op=pool_op)
        out = torch.relu(self.Dense_1(out))
        return self.Dense_2(out)[:, 0]


def qm9_operators(graph: Graph):
    """``{"segment_op", "sender_op", "pool_op"}`` of a batch on its
    device, built on the host, each over the batch's real entries: the
    ``SortedSegmentSum`` over its receivers (NNConv's messages), over its
    senders (NNConv's gather of its input) and over its batch vector
    (Set2Set)."""
    em = graph.real_edge_mask()
    return {"segment_op": SortedSegmentSum(graph.receivers,
                                           graph.num_nodes, entry_mask=em,
                                           device=graph.device),
            "sender_op": SortedSegmentSum(graph.senders, graph.num_nodes,
                                          entry_mask=em,
                                          device=graph.device),
            "pool_op": pool_operator(graph)}


def static_batch(loader: DataLoader, device) -> StaticBatch:
    """The static buffers of ``loader``'s budget on ``device``: its graph
    and the static forms of :func:`qm9_operators`' set (NNConv's sums by
    receiver and by sender, a slot for each edge; Set2Set's, a slot for
    each node)."""
    n, e = loader.num_nodes, loader.num_edges
    return StaticBatch(loader, {
        "segment_op": StaticSegmentSum(n, e, device=device),
        "sender_op": StaticSegmentSum(n, e, device=device),
        "pool_op": StaticSegmentSum(loader.num_graphs, n, device=device)},
        device)


def loss_of(pred, graph: Graph, mean: float, std: float):
    """The JAX script's loss: the squared error of the normalised target
    over the real graphs."""
    target = (graph.y[:, 0] - mean) / (std + 1e-12)
    m = graph.graph_mask.to(torch.float32)
    return (((pred - target) ** 2) * m).sum() / m.sum().clamp_min(1.0)


def train_step(model: Net, opt, graph: Graph, ops, mean: float,
               std: float):
    """One Adam step on one batch, the gradients zeroed in place (a
    captured step keeps them); the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model(graph, **ops), graph, mean, std)
    loss.backward()
    opt.step()
    return loss.detach()


def errors_of(model: Net, graph: Graph, ops, mean: float, std: float):
    """``(summed absolute error, graphs)`` of the de-normalised prediction
    over the batch's real graphs, as device scalars (the JAX script's
    ``eval_mae``)."""
    with torch.no_grad():
        pred = model(graph, **ops) * (std + 1e-12) + mean
    m = graph.graph_mask.to(torch.float32)
    return ((pred - graph.y[:, 0]).abs() * m).sum(), m.sum()


def captured_steps(model: Net, opt, train_loader: DataLoader,
                   test_loader: DataLoader, steps: int, dev, mean: float,
                   std: float, evals: int = 0):
    """``(train, test, step, predict, (curve, tally))``: the static
    batches of both loaders, the training step over ``train`` (its loss
    into the next row of ``curve``, a :class:`DeviceCurve` of ``steps``
    rows) and the evaluation over ``test`` (its batch's summed absolute
    error and graph count into the next row of ``tally``, ``evals``
    rows), each a :class:`CapturedStep` (QM9 draws no dropout)."""
    train = static_batch(train_loader, dev)
    test = static_batch(test_loader, dev)
    curve, tally = DeviceCurve(steps, 1, dev), DeviceCurve(evals, 2, dev)
    step = CapturedStep(lambda: curve.record(train_step(
        model, opt, train.graph, train.ops, mean, std)), dev)
    predict = CapturedStep(lambda: tally.record(*errors_of(
        model, test.graph, test.ops, mean, std)), dev)
    return train, test, step, predict, (curve, tally)


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
        num_samples: int = 1000, device="cuda", loaders=None,
        capture=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test, mean, std) replaces :func:`load`'s. ``capture`` (see
    the module docstring) None means captured on a card and eager on the
    CPU; True elsewhere than a card raises. Returns the last test MAE,
    the mean loss of each epoch, every step's loss, the operator sets
    built, the host seconds their build took, the run's seconds and the
    model; a captured run adds what
    ``models/capture.py:captured_metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    train_loader, test_loader, mean, std = loaders or load(
        seed, batch_size, num_samples, device=dev)
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, g0.num_edge_features,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                           capturable=dev.type == "cuda")
    train_ops = OperatorCache(qm9_operators)
    test_ops = OperatorCache(qm9_operators)
    n_train, n_test = len(train_loader), len(test_loader)
    host = {}
    if capture:
        train, test, step, predict, (curve, tally) = captured_steps(
            model, opt, train_loader, test_loader, epochs * n_train, dev,
            mean, std, epochs * n_test)
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
                                        train_ops(idx, graph), mean, std))
            for idx, graph in test_loader.indexed():
                tally.record(*errors_of(model, graph, test_ops(idx, graph),
                                        mean, std))
        losses = curve.host((epoch - 1) * n_train, epoch * n_train)[:, 0]
        errors = tally.host((epoch - 1) * n_test, epoch * n_test)
        # the JAX script's host sums, batch after batch
        tot = sum(float(v) for v in errors[:, 0])
        cnt = sum(float(v) for v in errors[:, 1])
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test MAE: {tot / max(cnt, 1):.4f}")
    out = {"mae": tot / max(cnt, 1), "epoch_losses": epoch_losses,
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
    p.add_argument("--epochs", type=int, default=5)
    args = p.parse_args()
    run(args.epochs)
