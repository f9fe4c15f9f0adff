"""Edge-partitioned GCN on synthetic Cora: the port's counterpart of
examples/distributed_gcn.py. A ``GraphPartition`` (window 256, dense
threshold 128: the partitioned SpMM's dense blocks, ``spmm_csr`` for the
sparse rest and the remote edges, the halo rows in bf16) and the stock
``DistGCN`` (hidden 16, dropout 0.5), whose layers are ``GCNConv``
called with ``shard_ctx``; Adam 0.01, 30 epochs.

    python -m pytorch_geometric_tpu_torch.examples.distributed_gcn \\
        [--epochs 30] [--hidden 16] [--seed 0] [--world-size N] \\
        [--device cuda|cpu]

The JAX script runs one controller over a device mesh; here each of
``--world-size`` ranks is a process (default: one per visible card, or
4 gloo ranks with ``--device cpu``). Rank 0 prints the JAX script's
lines.
"""

import argparse
import time

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets.synthetic import (
    synthetic_citation_graph)
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.citation import (
    softmax_xent_int_labels)
from pytorch_geometric_tpu_torch.parallel.api import GraphPartition
from pytorch_geometric_tpu_torch.parallel.mesh import rank_device, spawn
from pytorch_geometric_tpu_torch.parallel.models import DistGCN
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures


def load(seed: int = 0):
    """The host graph of the JAX script: synthetic Cora, features
    normalised, collated on the CPU. Built in the calling process and
    handed to the ranks: the synthetic corpus seeds from the process's
    string hash."""
    data = NormalizeFeatures()(synthetic_citation_graph("cora", seed=seed))
    return from_data(data, device="cpu")


def partition_edges(graph):
    """The real edges without self loops (``GraphPartition`` appends
    them), on the host."""
    emask = graph.real_edge_mask().numpy()
    s = graph.senders.numpy()[emask]
    r = graph.receivers.numpy()[emask]
    keep = s != r
    return s[keep], r[keep]


def nll_terms(logits, y_l, m_l):
    """The JAX script's ``loss_fn``: the masked cross-entropy's numerator
    and denominator on one shard."""
    nll = softmax_xent_int_labels(logits, y_l)
    return (nll * m_l).sum(), m_l.sum()


def train_rank(rank: int, graph, epochs: int = 30, hidden: int = 16,
               seed: int = 0, world_size: int = 1, device="cuda"):
    """One rank's run on the host ``graph``: the accuracies, the losses,
    the logits (every rank's, gathered and unsharded), the seconds of the
    epochs and the state dict."""
    dev = rank_device(device)
    N = graph.num_nodes
    s, r = partition_edges(graph)
    part = GraphPartition(s, r, N, world_size, window=256,
                          dense_threshold=128, device=dev)
    C = int(graph.y.max()) + 1
    x_sh = part.shard_nodes(graph.x)
    y_sh = part.shard_nodes(graph.y)
    m_sh = part.shard_nodes(graph.train_mask.float())
    model = part.init_model(
        DistGCN(graph.num_node_features, hidden, C),
        x_sh, torch.Generator().manual_seed(seed), has_rng=True)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    step = part.make_train_step(model, opt, nll_terms, has_rng=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        model, opt, loss = step(model, opt, x_sh, y_sh, m_sh, gen)
        losses.append(loss)
        if rank == 0 and (epoch % 10 == 0 or epoch == 1):
            print(f"Epoch {epoch:03d}  loss {float(loss):.4f}")
    losses = torch.stack(losses).cpu().numpy()
    seconds = time.perf_counter() - t0
    logits = part.unshard_nodes(part.apply_model(model, model, x_sh))
    pred = np.argmax(logits, axis=1)
    y = graph.y.numpy()

    def acc(mask):
        m = mask.numpy().astype(bool)
        return float((pred[m] == y[m]).mean()) if m.any() else 0.0

    out = {"train": acc(graph.train_mask), "val": acc(graph.val_mask),
           "test": acc(graph.test_mask), "losses": losses,
           "logits": logits, "seconds": seconds,
           "state_dict": {k: v.cpu() for k, v in model.state_dict().items()}}
    if rank == 0:
        print(f"devices={world_size}  train {out['train']:.4f}  "
              f"val {out['val']:.4f}  "
              f"test {out['test']:.4f}")
    return out


def default_world_size(device) -> int:
    """One rank per visible card; 4 gloo ranks on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 4


def run(epochs: int = 30, hidden: int = 16, seed: int = 0,
        world_size=None, device="cuda"):
    """Train on ``world_size`` ranks; rank 0's result."""
    resolve_device(device)
    n = world_size or default_world_size(device)
    return spawn(train_rank, n, load(seed), epochs, hidden, seed, n,
                 device, device=device)[0]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run(epochs=a.epochs, hidden=a.hidden, seed=a.seed,
        world_size=a.world_size, device=a.device)
