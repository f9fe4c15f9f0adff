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
vector, through which each level's mean runs (the segment-sum kernel),
the nodes a pool dropped masked on the device. The max is torch's
``scatter_reduce``. No level needs a host step of its own: the pool's
ranks (two stable sorts and a ``searchsorted``) and masks stay on the
device.

The JAX script jits its training step and its evaluation once over the
loaders' static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of its loader's budget
(``examples/mutag_gin.py:static_batch``: the graph, a
``StaticSpmmOperator`` and the readout's ``StaticSegmentSum``), each
batch's operator set built on the host and copied in before the replay;
the training step draws its dropout from the generator registered with
the graph, and Adam keeps its step count on the device. ``capture=False``
runs the same steps eagerly over each batch's own tensors (the CPU's
only mode). Prints the JAX script's line per epoch.
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
    accuracy_of, loss_of, mutag_operators, static_batch)
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, captured_metrics, resolve_capture,
    static_batches)
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
    False, the gradients zeroed in place (a captured step keeps them);
    the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model(graph, train=train, generator=generator, **ops),
                   graph)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: Net, loader: DataLoader, ops: OperatorCache):
    """Accuracy of the argmax over the loader's real graphs."""
    with torch.no_grad():
        return accuracy_of((graph, model(graph, **ops(idx, graph)))
                           for idx, graph in loader.indexed())


def captured_steps(model: Net, opt, train_loader: DataLoader,
                   test_loader: DataLoader, steps: int, dev, generator):
    """``(train, test, step, predict, curve)``: the static batches of both
    loaders, the training step over ``train`` (dropout from
    ``generator``, its loss into the next row of ``curve``, a
    :class:`DeviceCurve` of ``steps`` rows) and the evaluation's logits
    over ``test``, each a :class:`CapturedStep`."""
    train = static_batch(train_loader, dev)
    test = static_batch(test_loader, dev)
    curve = DeviceCurve(steps, 1, dev)
    step = CapturedStep(lambda: curve.record(train_step(
        model, opt, train.graph, train.ops, generator)), dev,
        generator=generator)

    def logits():
        with torch.no_grad():
            return model(test.graph, **test.ops)

    return train, test, step, CapturedStep(logits, dev), curve


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
        device="cuda", loaders=None, capture=None):
    """Train and print the JAX script's line per epoch; returns what
    examples/mutag_gin.py's ``run`` returns (``capture`` as there)."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    g0 = next(iter(train_loader))
    model = Net(g0.num_node_features, 6,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4,
                           capturable=dev.type == "cuda")
    drop = torch.Generator(device=dev).manual_seed(seed)
    if capture:
        train, test, step, predict, curve = captured_steps(
            model, opt, train_loader, test_loader,
            epochs * len(train_loader), dev, drop)
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
            losses = [train_step(model, opt, graph, train_ops(idx, graph),
                                 drop)
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
    p.add_argument("--epochs", type=int, default=20)
    args = p.parse_args()
    run(args.epochs)
