"""Data-parallel graph classification on MUTAG: the port's counterpart
of examples/data_parallel.py (the reference's DataListLoader +
nn.DataParallel). ``GraphClassifier`` (two GCN layers of 32, mean
readout, linear head), batches of 4 graphs per rank drawn from one
shuffled list loader, Adam 1e-2, 5 epochs.

    python -m pytorch_geometric_tpu_torch.examples.data_parallel \\
        [--epochs 5]

One rank per visible card (NCCL; ``run(world_size=2, device="cpu")``
runs two gloo ranks). Every rank iterates the same loader, takes its
round-robin shard of each list (``shard_data_list``), builds that
shard's operators on the host (:func:`batch_operators`: the
``SpmmOperator`` of its GCN edge set, through which both GCN sums run on
the ``spmm_csr`` kernel, and the readout's ``SortedSegmentSum``) and
steps through ``DataParallelTrainer``, which averages the gradients over
the ranks in rank order. A step launches 4 ``spmm_csr`` (2 forward, 2
``dx``) and 1 ``sorted_segment_sum``; a forward alone 2 and 1. Rank 0
prints the JAX script's lines.
"""

import argparse
import time

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data import DataListLoader
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.datasets import TUDataset
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.models.graph_pred import (
    GraphClassifier, graph_xent_loss)
from pytorch_geometric_tpu_torch.nn.pool import pool_operator
from pytorch_geometric_tpu_torch.parallel import (
    DataParallelTrainer, make_mesh, shard_data_list)
from pytorch_geometric_tpu_torch.parallel.mesh import rank_device, spawn

GRAPHS_PER_RANK = 4


def batch_operators(graph: Graph):
    """``{"aggregate_fn", "segment_op"}`` of ``GraphClassifier`` for one
    collated batch, on its device."""
    op, w = gcn_spmm_operator(graph)
    return {"aggregate_fn": op.bind(w), "segment_op": pool_operator(graph)}


def batch_loss(model, graph: Graph, rng=None):
    """The JAX script's loss on one shard: cross-entropy over its real
    graphs, through the shard's operators."""
    logits = model(graph, **batch_operators(graph))
    return graph_xent_loss(logits, graph.y, graph.graph_mask)


def budgets(dataset):
    """Per-shard (nodes, edges): four of the largest graphs, plus the
    padding node."""
    max_n = max(d.num_nodes for d in dataset) * GRAPHS_PER_RANK + 1
    max_e = max(d.num_edges for d in dataset) * GRAPHS_PER_RANK
    return max_n, max_e


def train_rank(rank: int, epochs: int = 5, seed: int = 0, device="cuda",
               root=PLANETOID_ROOT, verbose: bool = True):
    """One rank's run: the model's state dict, the mean loss of each
    epoch and every step's loss (the same on every rank)."""
    dev = rank_device(device)
    mesh = make_mesh()
    n_dev = mesh.size()
    if verbose and rank == 0:
        print(f"Let's use {n_dev} devices!")
    ds = TUDataset(str(root), "MUTAG")
    loader = DataListLoader(ds, batch_size=n_dev * GRAPHS_PER_RANK,
                            shuffle=True, seed=seed)
    max_n, max_e = budgets(ds)
    model = GraphClassifier(ds.num_node_features, hidden_channels=32,
                            num_classes=2,
                            generator=torch.Generator().manual_seed(seed)
                            ).to(dev)
    trainer = DataParallelTrainer(
        mesh, batch_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    opt = trainer.init(model)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = []
        for data_list in loader:
            stacked = shard_data_list(data_list, n_dev, max_n, max_e,
                                      GRAPHS_PER_RANK, device=dev)
            model, opt, loss = trainer.step(model, opt, stacked, None)
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        if verbose and rank == 0:
            print(f"Epoch {epoch:02d}, Loss: {epoch_losses[-1]:.4f}")
    return {"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
            "epoch_losses": epoch_losses,
            "step_losses": np.concatenate(step_losses),
            "seconds": time.perf_counter() - t0}


def default_world_size(device) -> int:
    """One rank per visible card; one on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def run(epochs: int = 5, seed: int = 0, world_size=None, device="cuda",
        root=PLANETOID_ROOT):
    """Train on ``world_size`` ranks; rank 0's result."""
    n = world_size or default_world_size(device)
    return spawn(train_rank, n, epochs, seed, device, root,
                 device=device)[0]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=5)
    args = p.parse_args()
    run(args.epochs)
