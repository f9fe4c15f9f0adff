"""Data-parallel MNISTSuperpixels classification: the port's counterpart
of examples/mnist_data_parallel.py (the reference's examples/test.py,
its second DataParallel script). ``GraphClassifier`` (two GCN layers of
32, mean readout, 10 classes) over 512 synthetic superpixel graphs,
batches of 32 split over the ranks, Adam 1e-3, one epoch; a list tail
smaller than the rank count is skipped.

    python -m pytorch_geometric_tpu_torch.examples.mnist_data_parallel \\
        [--epochs 1] [--batch_size 32]

One rank per visible card (NCCL), or ``run(..., world_size=2,
device="cpu")``. Each rank's shard runs through its operators
(``examples/data_parallel.py:batch_operators``: ``spmm_csr`` and the
segment-sum kernel); ``DataParallelTrainer`` averages in rank order.
Rank 0 prints the JAX script's line per epoch.
"""

import argparse

import torch

from pytorch_geometric_tpu_torch.data import DataListLoader
from pytorch_geometric_tpu_torch.data.batch import bucket_size
from pytorch_geometric_tpu_torch.datasets import MNISTSuperpixels
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.examples.data_parallel import (
    batch_loss, default_world_size)
from pytorch_geometric_tpu_torch.models.graph_pred import GraphClassifier
from pytorch_geometric_tpu_torch.parallel import (
    DataParallelTrainer, make_mesh, shard_data_list)
from pytorch_geometric_tpu_torch.parallel.mesh import rank_device, spawn


def train_rank(rank: int, epochs: int = 1, batch_size: int = 32,
               num_samples: int = 512, seed: int = 0, device="cuda",
               root=PLANETOID_ROOT):
    """One rank's run: the mean loss over every step, and the steps."""
    dev = rank_device(device)
    mesh = make_mesh()
    n_dev = mesh.size()
    ds = MNISTSuperpixels(str(root), train=True, num_synthetic=num_samples)
    batch_size = max(batch_size // n_dev, 1) * n_dev
    gps = batch_size // n_dev
    shard_nodes = bucket_size(gps * 76 + 1)
    shard_edges = bucket_size(gps * 75 * 8 * 2)
    loader = DataListLoader(ds, batch_size=batch_size, shuffle=True,
                            seed=seed)
    model = GraphClassifier(ds.num_node_features, hidden_channels=32,
                            num_classes=10,
                            generator=torch.Generator().manual_seed(seed)
                            ).to(dev)
    trainer = DataParallelTrainer(
        mesh, batch_loss, lambda ps: torch.optim.Adam(ps, lr=1e-3))
    opt = trainer.init(model)
    losses = []
    for epoch in range(epochs):
        for data_list in loader:
            if len(data_list) < n_dev:
                continue
            stacked = shard_data_list(data_list, n_dev, shard_nodes,
                                      shard_edges, gps, device=dev)
            model, opt, loss = trainer.step(model, opt, stacked, None)
            losses.append(loss)
        mean = float(torch.stack(losses).mean())
        if rank == 0:
            print(f"Epoch {epoch + 1}: mean loss "
                  f"{mean:.4f} over {n_dev} devices")
    return {"mean_loss": mean,
            "step_losses": torch.stack(losses).cpu().numpy()}


def run(epochs: int = 1, batch_size: int = 32, num_samples: int = 512,
        seed: int = 0, world_size=None, device="cuda",
        root=PLANETOID_ROOT):
    """Train on ``world_size`` ranks; rank 0's mean loss."""
    n = world_size or default_world_size(device)
    return spawn(train_rank, n, epochs, batch_size, num_samples, seed,
                 device, root, device=device)[0]["mean_loss"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    args = p.parse_args()
    run(args.epochs, args.batch_size)
