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
and reused in every epoch (``examples/ppi.py:OperatorCache``). The step
runs eagerly. Prints the JAX script's line per epoch.
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
from pytorch_geometric_tpu_torch.nn.conv import SplineConv, spline_operator
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


def faust_spline_op(graph: Graph):
    """The batch's rectangular spline operator (fp32), on the graph's
    device: the (N·125, N) accumulator of every layer."""
    return spline_operator(graph, DIM, KERNEL_SIZE)


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
    False; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = nll_loss(model(graph, train=train, spline_op=op,
                          generator=generator), graph)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: Net, loader: DataLoader, ops: OperatorCache):
    """Accuracy of the argmax over the loader's real vertices."""
    correct = total = 0
    with torch.no_grad():
        for idx, graph in loader.indexed():
            pred = model(graph, spline_op=ops(idx, graph)).argmax(dim=1)
            m = graph.node_mask
            correct += int(((pred == graph.y.long()) & m).sum())
            total += int(m.sum())
    return correct / max(total, 1)


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
        device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch. ``loaders``
    (train, test) replaces :func:`load`'s. Returns the last test
    accuracy, the mean loss of each epoch, every step's loss, the
    operators built, the host seconds their build took and the run's
    seconds."""
    dev = resolve_device(device)
    train_loader, test_loader = loaders or load(seed, num_vertices,
                                                device=dev)
    nv = train_loader.dataset[0].num_nodes
    # the JAX script takes its first batch to shape the model, which
    # draws one epoch's order from the loader's generator
    next(iter(train_loader))
    model = Net(nv, generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    drop = torch.Generator(device=dev).manual_seed(seed)
    train_ops = OperatorCache(faust_spline_op)
    test_ops = OperatorCache(faust_spline_op)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, graph, train_ops(idx, graph), drop)
                  for idx, graph in train_loader.indexed()]
        acc = evaluate(model, test_loader, test_ops)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "operators": len(train_ops.ops) + len(test_ops.ops),
            "operator_seconds": train_ops.seconds + test_ops.seconds,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args()
    run(args.epochs)
