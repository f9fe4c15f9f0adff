"""GraphSAGE with neighbour sampling on Reddit: the port's counterpart of
examples/reddit_sage.py (the sampled mini-batch configuration
"GraphSAGE + NeighborSampler on PPI/Reddit"). ``SAGEConv(602 -> 128)``,
ReLU, ``SAGEConv(128 -> 41)``; fan-out [10, 10], batches of 512 training
nodes, Adam 3e-3, the loss over the seed rows; each epoch stops after
``max_batches`` batches and evaluates ``max_batches // 2`` validation
batches.

    python -m pytorch_geometric_tpu_torch.examples.reddit_sage [--epochs 1]

Batches ship indices only (``materialize_features=False``): the feature
and label tables stay on the card (``NeighborSampler.device_tables``) and
each step gathers its rows through ``local_to_global``. Each batch's
neighbour sum is one ``EmbedSpmm`` over its real edges
(:func:`sage_aggregate`, weights 1, one ``spmm_csr`` a direction): the
padding edges sit on the sentinel row with weight 0 in the JAX batch, so
leaving them out changes no sum, and no padding row remains. Each
``SAGEConv`` sums its input and a column of ones (its degrees) through
it, so a training step launches ``spmm_csr`` 5 times (each layer's two
forward sums, and conv2's ``dx``: conv1's input, the gathered features,
takes no gradient), an evaluation batch 4. The step runs eagerly: every
batch has its own operator.
"""

import argparse
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.data.neighbor_loader import NeighborSampler
from pytorch_geometric_tpu_torch.datasets import Reddit
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.nn.conv import SAGEConv
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.embed_spmm import EmbedSpmm


class SAGE(nn.Module):
    """examples/reddit_sage.py's ``SAGE``, with its parameter names
    (``conv1``, ``conv2``)."""

    def __init__(self, in_channels: int = 602, hidden: int = 128,
                 num_classes: int = 41, generator=None):
        super().__init__()
        self.conv1 = SAGEConv(in_channels, hidden, generator=generator)
        self.conv2 = SAGEConv(hidden, num_classes, generator=generator)

    def forward(self, graph: Graph, x, aggregate=None):
        """``aggregate``: the batch's :func:`sage_aggregate` (None: the
        plain sums, on a CPU tensor only)."""
        x = torch.relu(self.conv1(graph, x, aggregate_fn=aggregate))
        return self.conv2(graph, x, aggregate_fn=aggregate)


def sage_aggregate(graph: Graph) -> EmbedSpmm:
    """``x -> sum_{real edges s -> r} x[s]`` into the batch's rows: an
    ``EmbedSpmm`` (weights 1, fp32) over the batch's real edges, built on
    the host from the batch's indices, on the batch's device."""
    real = host_array(graph.real_edge_mask())
    n = graph.num_nodes
    return EmbedSpmm(host_array(graph.senders)[real],
                     host_array(graph.receivers)[real], n, n,
                     device=graph.senders.device)


def seed_loss(logits, y, seed_mask):
    """Mean negative log-likelihood over the seed rows (the JAX script's
    one-hot form: every row's NLL, masked)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, y.long()[:, None])[:, 0]
    m = seed_mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def train_step(model: SAGE, opt, graph: Graph, x_dev, y_dev):
    """One Adam step on one batch, its rows gathered from the tables on
    the card; the loss stays on the device."""
    ids = graph.extras["local_to_global"].long()
    x, y = x_dev[ids], y_dev[ids]
    opt.zero_grad(set_to_none=True)
    loss = seed_loss(model(graph, x, sage_aggregate(graph)), y,
                     graph.extras["seed_mask"])
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: SAGE, graph: Graph, x_dev, y_dev):
    """``(correct, seeds)`` of one batch, device scalars."""
    ids = graph.extras["local_to_global"].long()
    pred = model(graph, x_dev[ids], sage_aggregate(graph)).argmax(dim=1)
    m = graph.extras["seed_mask"]
    return ((pred == y_dev[ids].long()) & m).sum(), m.sum()


def loaders(data, batch_size: int = 512, seed: int = 0, prefetch: int = 0,
            device="cuda"):
    """``(train loader, val loader, x table, y table)`` of the JAX script
    over ``data`` (a Reddit ``Data``): index-shipping loaders with
    fan-out [10, 10], the train one shuffled from ``seed``, the val one
    in order; the tables on ``device`` with their sentinel zero row."""
    ei = np.asarray(data.edge_index)
    kw = dict(sizes=[10, 10], batch_size=batch_size,
              materialize_features=False, prefetch=prefetch,
              device=device)
    train = NeighborSampler(ei[0], ei[1], data.num_nodes,
                            seed_nodes=np.flatnonzero(data.train_mask),
                            seed=seed, **kw)
    val = NeighborSampler(ei[0], ei[1], data.num_nodes,
                          seed_nodes=np.flatnonzero(data.val_mask),
                          shuffle=False, **kw)
    x_dev, y_dev = train.device_tables(np.asarray(data.x, np.float32),
                                       np.asarray(data.y, np.int32))
    return train, val, x_dev, y_dev


def run(epochs: int = 1, batch_size: int = 512, seed: int = 0,
        max_batches: int = 20, device="cuda", data=None):
    """Train and print the JAX script's line per epoch. ``data`` replaces
    ``Reddit(datasets_cache)[0]`` (N_FULL // 8 nodes). Returns the last
    validation accuracy, each step's loss, the chance level and the run's
    seconds."""
    dev = resolve_device(device)
    if data is None:
        data = Reddit(str(PLANETOID_ROOT))[0]
    train, val, x_dev, y_dev = loaders(data, batch_size, seed, device=dev)
    num_classes = int(np.asarray(data.y).max()) + 1
    # the JAX script takes a first batch to shape the model, which draws
    # one epoch's order and one batch's samples from the loader's stream
    next(iter(train))
    model = SAGE(x_dev.shape[1], 128, num_classes,
                 generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    step_losses = []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses = []
        for i, graph in enumerate(train):
            if i >= max_batches:
                break
            losses.append(train_step(model, opt, graph, x_dev, y_dev))
        cor = tot = 0
        for i, graph in enumerate(val):
            if i >= max_batches // 2:
                break
            c, t = eval_step(model, graph, x_dev, y_dev)
            cor, tot = cor + int(c), tot + int(t)
        losses = torch.stack(losses).cpu().numpy()
        step_losses.append(losses)
        print(f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
              f"Val Acc: {cor / max(tot, 1):.4f}")
    return {"acc": cor / max(tot, 1), "step_losses": np.stack(step_losses),
            "chance": 1.0 / num_classes,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=1)
    args = p.parse_args()
    run(args.epochs)
