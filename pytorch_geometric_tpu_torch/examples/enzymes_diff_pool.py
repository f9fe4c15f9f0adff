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
"""

import argparse
import time
from math import ceil

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pytorch_geometric_tpu_torch.data import DenseDataLoader
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.nn.conv import DenseSAGEConv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool import dense_diff_pool
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
    """One Adam step on one batch; the loss stays on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model, batch)
    loss.backward()
    opt.step()
    return loss.detach()


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
        device="cuda", loaders=None):
    """Train and print the JAX script's line per epoch. Returns the last
    test accuracy, the mean loss of each epoch, every step's loss and the
    run's seconds."""
    dev = resolve_device(device)
    train_loader, test_loader = loaders or load(seed, batch_size,
                                                device=dev)
    b0 = next(iter(train_loader))
    model = DiffPoolNet(b0.x.shape[-1], 6,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = [train_step(model, opt, b) for b in train_loader]
        cor = tot = 0
        with torch.no_grad():
            for b in test_loader:
                logits, _, _ = model(b.x, b.adj, b.mask)
                cor += int((logits.argmax(1) == b.y.long()).sum())
                tot += int(b.y.shape[0])
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}, "
              f"Test Acc: {cor / max(tot, 1):.4f}")
    return {"acc": cor / max(tot, 1), "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=8)
    args = p.parse_args()
    run(args.epochs)
