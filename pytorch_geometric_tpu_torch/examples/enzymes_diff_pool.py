"""DiffPool on ENZYMES: the port's counterpart of
examples/enzymes_diff_pool.py. ``ToDense(126)`` as the pre-transform (the
graphs of at most 126 nodes) and ``DenseDataLoader`` batches (x (B, 126,
3), adj (B, 126, 126), mask); blocks of three ``DenseSAGEConv``
(normalised, ReLU); two ``dense_diff_pool`` levels (to 32, then 8
clusters) with their link and entropy losses added to the
cross-entropy; a mean over the clusters, Dense 64 (ReLU), Dense to 6
classes. Adam 1e-3, batches of 32 shuffled from ``seed``, 8 epochs.

    python -m pytorch_geometric_tpu_torch.examples.enzymes_diff_pool

Every product is a dense batched matrix product (``torch.einsum``), as in
the JAX script, which computes them outside any Pallas kernel: this path
runs no kernel of the port. Prints the JAX script's line per epoch.

The JAX script jits its training step and its evaluation, which trace
once per batch shape: the loaders' last batches can be smaller, and the
loss is a mean over the batch, so no batch is padded. Here, on a card,
each step is a CUDA graph captured once for each distinct batch size
(:class:`SizedStep`, ``capture=None`` or ``True``) over static buffers of
that size's ``(x, adj, mask, y)``, each host batch copied in before the
replay, and Adam keeps its step count on the device. ``capture=False``
runs the same steps eagerly over each batch (the CPU's only mode).
"""

import argparse
import time
from math import ceil

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_geometric_tpu_torch.data import DenseDataLoader
from pytorch_geometric_tpu_torch.data.loader import DenseBatch
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    CapturedStep, DeviceCurve, captured_metrics, resolve_capture)
from pytorch_geometric_tpu_torch.nn.conv import DenseSAGEConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool import dense_diff_pool
from pytorch_geometric_tpu_torch.ops.csr import copy_into
from pytorch_geometric_tpu_torch.transforms import ToDense

MAX_NODES = 126
#: The JAX script's dataset root (it holds no raw files: the synthetic
#: corpus).
DENSE_ROOT = PLANETOID_ROOT.parent / "datasets_cache_dense"


class GNN(nn.Module):
    """Three ``DenseSAGEConv`` (``conv0`` .. ``conv2``), ReLU after each."""

    def __init__(self, in_channels: int, hidden: int, out: int,
                 generator=None):
        super().__init__()
        for i, (a, b) in enumerate(zip((in_channels, hidden, hidden),
                                       (hidden, hidden, out))):
            setattr(self, f"conv{i}", DenseSAGEConv(
                a, b, normalize=True, generator=generator))

    def forward(self, x, adj, mask=None):
        for i in range(3):
            x = torch.relu(getattr(self, f"conv{i}")(x, adj, mask))
        return x


class DiffPoolNet(nn.Module):
    """examples/enzymes_diff_pool.py's ``DiffPoolNet`` with its parameter
    names."""

    def __init__(self, in_channels: int, num_classes: int,
                 hidden: int = 64, generator=None):
        super().__init__()
        n1 = ceil(0.25 * MAX_NODES)
        n2 = ceil(0.25 * n1)
        self.gnn1_pool = GNN(in_channels, hidden, n1, generator)
        self.gnn1_embed = GNN(in_channels, hidden, hidden, generator)
        self.gnn2_pool = GNN(hidden, hidden, n2, generator)
        self.gnn2_embed = GNN(hidden, hidden, hidden, generator)
        self.gnn3_embed = GNN(hidden, hidden, hidden, generator)
        self.Dense_0 = Dense(hidden, hidden, generator=generator)
        self.Dense_1 = Dense(hidden, num_classes, generator=generator)

    def forward(self, x, adj, mask):
        s = self.gnn1_pool(x, adj, mask)
        z = self.gnn1_embed(x, adj, mask)
        x, adj, l1, e1 = dense_diff_pool(z, adj, s, mask)
        s = self.gnn2_pool(x, adj)
        z = self.gnn2_embed(x, adj)
        x, adj, l2, e2 = dense_diff_pool(z, adj, s)
        z = self.gnn3_embed(x, adj)
        h = z.mean(1)
        h = torch.relu(self.Dense_0(h))
        return self.Dense_1(h), l1 + l2, e1 + e2


def loss_of(model: DiffPoolNet, batch):
    """The JAX script's loss: mean cross-entropy + link + entropy."""
    logits, ll, el = model(batch.x, batch.adj, batch.mask)
    return F.cross_entropy(logits, batch.y.long()) + ll + el


def train_step(model: DiffPoolNet, opt, batch):
    """One Adam step on one batch, the gradients zeroed in place (a
    captured step keeps them); the loss stays on the device."""
    opt.zero_grad(set_to_none=False)
    loss = loss_of(model, batch)
    loss.backward()
    opt.step()
    return loss.detach()


def correct_of(model: DiffPoolNet, batch):
    """The count of the batch's graphs whose argmax is their label (a
    device scalar)."""
    with torch.no_grad():
        logits, _, _ = model(batch.x, batch.adj, batch.mask)
    return (logits.argmax(1) == batch.y.long()).sum()


class SizedStep:
    """``body(batch)`` as one :class:`CapturedStep` for each distinct batch
    size, over static buffers of that size's dense fields on ``dev``.
    Each call copies a host batch into its size's buffers on the current
    stream (through pinned memory, no host wait) and calls that size's
    step: its warm-up, then the capture, then a replay. ``host`` adds
    each call's seconds (``seconds`` and ``copy_seconds``) and counts
    ``batches``."""

    def __init__(self, body, dev, host):
        self.body, self.dev, self.host = body, dev, host
        self.buffers, self.steps = {}, {}

    def __call__(self, batch: DenseBatch):
        t0 = time.perf_counter()
        size = batch.num_graphs
        if size not in self.steps:
            static = DenseBatch({k: torch.empty(v.shape, dtype=v.dtype,
                                                device=self.dev)
                                 for k, v in batch.items()})
            self.buffers[size] = static
            self.steps[size] = CapturedStep(lambda: self.body(static),
                                            self.dev)
        for k, v in batch.items():
            copy_into(self.buffers[size][k], v)
        dt = time.perf_counter() - t0
        for key, v in (("seconds", dt), ("copy_seconds", dt),
                       ("batches", 1)):
            self.host[key] = self.host.get(key, 0) + v
        return self.steps[size]()


def load(seed: int = 0, batch_size: int = 32, root=DENSE_ROOT,
         device="cuda"):
    """``(train loader, test loader)`` of the JAX script."""
    ds = TUDataset(str(root), "ENZYMES", pre_transform=ToDense(MAX_NODES),
                   pre_filter=lambda d: d.num_nodes <= MAX_NODES)
    sh = ds.shuffle(seed=seed)
    n = len(sh)
    test_ds, train_ds = sh[: n // 10], sh[n // 10:]
    return (DenseDataLoader(train_ds, batch_size=batch_size, shuffle=True,
                            seed=seed, device=device),
            DenseDataLoader(test_ds, batch_size=batch_size, device=device))


def run(epochs: int = 8, batch_size: int = 32, seed: int = 0,
        device="cuda", loaders=None, capture=None):
    """Train and print the JAX script's line per epoch. ``capture`` (see
    the module docstring) None means captured on a card and eager on the
    CPU; True elsewhere than a card raises. Returns the last test
    accuracy, the mean loss of each epoch, every step's loss, the run's
    seconds and the model; a captured run adds what
    ``models/capture.py:captured_metrics`` gives, with one training and
    one evaluation step a batch size (``train_<size>``,
    ``evaluation_<size>``)."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    b0 = next(iter(train_loader))
    model = DiffPoolNet(b0.x.shape[-1], 6,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                           capturable=dev.type == "cuda")
    if capture:
        host = {}
        curve = DeviceCurve(epochs * len(train_loader), 1, dev)
        step = SizedStep(lambda b: curve.record(train_step(model, opt, b)),
                         dev, host)
        predict = SizedStep(lambda b: correct_of(model, b), dev, host)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        cor = tot = 0
        if capture:
            for b in _timed(train_loader.batches("cpu"), host):
                step(b)
            for b in _timed(test_loader.batches("cpu"), host):
                cor += int(predict(b))
                tot += b.num_graphs
            n = len(train_loader)
            losses = curve.host((epoch - 1) * n, epoch * n)[:, 0]
        else:
            losses = [train_step(model, opt, b) for b in train_loader]
            for b in test_loader:
                cor += int(correct_of(model, b))
                tot += b.num_graphs
            losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {cor / max(tot, 1):.4f}")
    out = {"acc": cor / max(tot, 1), "epoch_losses": epoch_losses,
           "step_losses": np.stack(step_losses),
           "seconds": time.perf_counter() - t0, "model": model}
    if capture:
        out.update(captured_metrics(
            {**{f"train_{k}": v for k, v in step.steps.items()},
             **{f"evaluation_{k}": v for k, v in predict.steps.items()}},
            {"operator_seconds": 0.0, **host}))
    return out


def _timed(batches, host):
    """``batches``, each one's stacking on the host added to
    ``host["seconds"]`` and ``host["collate_seconds"]``."""
    while True:
        t0 = time.perf_counter()
        try:
            b = next(batches)
        except StopIteration:
            return
        dt = time.perf_counter() - t0
        host["seconds"] = host.get("seconds", 0) + dt
        host["collate_seconds"] = host.get("collate_seconds", 0) + dt
        yield b


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=8)
    args = p.parse_args()
    run(args.epochs)
