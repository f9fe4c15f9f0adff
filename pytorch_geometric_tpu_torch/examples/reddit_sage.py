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
takes no gradient), an evaluation batch 4. The operator is built on the
host by the sampler, beside its sampling (``NeighborSampler.iter_host``;
in its producer thread when it prefetches), never inside the step.

The JAX script jits its training step and its evaluation once over the
sampler's static budgets. Here, on a card, each is a CUDA graph captured
once (``models/capture.py:CapturedStep``, ``capture=None`` or ``True``)
over static buffers of the sampler's budgets (:class:`StaticSampled`:
the packed index batch, ``NeighborSampler.pack_batch``'s one int32
buffer, and a ``StaticBiSpmm`` of the neighbour sums, a slot an edge of
the budget: the same call as the batch's ``EmbedSpmm``, so the captured
run equals the eager one bitwise). Each batch and its operator are
copied in on the current stream through pinned memory, then the graph
replays; the step unpacks the buffer and gathers its feature and label
rows inside the graph. Adam keeps its step count on the card; the losses
and the evaluation's counts stay in device buffers until the epoch ends
(``models/capture.py:StepLoop`` over :class:`Sampled` batches).
``capture=False`` copies each batch and its operator to the device and
runs the same steps eagerly (the CPU's only mode). The sampler bounds
the run's wall time; ``host_*_seconds`` report its share.
"""

import argparse
import itertools
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.data.neighbor_loader import NeighborSampler
from pytorch_geometric_tpu_torch.datasets import Reddit
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    StepLoop, resolve_capture)
from pytorch_geometric_tpu_torch.nn.conv import SAGEConv
from pytorch_geometric_tpu_torch.ops.csr import copy_into, host_array
from pytorch_geometric_tpu_torch.ops.embed_spmm import EmbedSpmm
from pytorch_geometric_tpu_torch.ops.spmm import StaticBiSpmm


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


def sage_aggregate(graph: Graph, device=None) -> EmbedSpmm:
    """``x -> sum_{real edges s -> r} x[s]`` into the batch's rows: an
    ``EmbedSpmm`` (weights 1, fp32) over the batch's real edges, built on
    the host from the batch's indices, on ``device`` (default: the
    batch's)."""
    real = host_array(graph.real_edge_mask())
    n = graph.num_nodes
    return EmbedSpmm(host_array(graph.senders)[real],
                     host_array(graph.receivers)[real], n, n,
                     device=graph.senders.device if device is None
                     else device)


class StaticSampled:
    """The static buffers of ``sampler``'s budgets on ``device``: the
    packed index batch (:meth:`NeighborSampler.pack_batch`'s int32
    buffer) and ``ops["aggregate"]``, a ``StaticBiSpmm`` of the neighbour
    sums (node budget rows over node budget columns, a slot an edge of
    the edge budget), which a captured step reads. :meth:`load` copies a
    host batch and its host :func:`sage_aggregate` in on the current
    stream; :attr:`graph` unpacks the buffer, inside the step, so that
    each replay reads the batch copied in before it."""

    def __init__(self, sampler: NeighborSampler, device):
        n, e = sampler.node_budget, sampler.edge_budget
        self.sampler = sampler
        self.packed = torch.zeros(3 * e + 3 * n, dtype=torch.int32,
                                  device=device)
        self.ops = {"aggregate": StaticBiSpmm(n, n, e, device=device)}

    def load(self, graph: Graph, ops):
        """Copy a host batch and its ``{"aggregate"}`` in."""
        packed = torch.from_numpy(self.sampler.pack_batch(graph))
        if packed.shape != self.packed.shape:
            raise ValueError(f"a packed batch of {packed.shape[0]} values "
                             f"does not fit static buffers of "
                             f"{self.packed.shape[0]}")
        copy_into(self.packed, packed)
        aggregate = ops["aggregate"]
        self.ops["aggregate"].load((aggregate.geom, aggregate.consts))

    @property
    def graph(self) -> Graph:
        return self.sampler.unpack(self.packed)


def seed_loss(logits, y, seed_mask):
    """Mean negative log-likelihood over the seed rows (the JAX script's
    one-hot form: every row's NLL, masked)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        1, y.long()[:, None])[:, 0]
    m = seed_mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def train_step(model: SAGE, opt, graph: Graph, x_dev, y_dev, aggregate):
    """One Adam step on one batch, its rows gathered from the tables on
    the card, the gradients zeroed in place (a captured step keeps them);
    ``aggregate`` the batch's :func:`sage_aggregate` on its device. The
    loss stays on the device."""
    ids = graph.extras["local_to_global"].long()
    x, y = x_dev[ids], y_dev[ids]
    opt.zero_grad(set_to_none=False)
    loss = seed_loss(model(graph, x, aggregate), y,
                     graph.extras["seed_mask"])
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: SAGE, graph: Graph, x_dev, y_dev, aggregate):
    """``(correct, seeds)`` of one batch, device scalars."""
    ids = graph.extras["local_to_global"].long()
    pred = model(graph, x_dev[ids], aggregate).argmax(dim=1)
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


class Sampled:
    """A source of host batches for ``models/capture.py:StepLoop``: the
    first ``limit`` batches an epoch of ``loader``, each ``(batch,
    {"aggregate": operator})`` on the host (``iter_host`` of a host
    :func:`sage_aggregate`; in the producer thread when the loader
    prefetches). ``host["operator_seconds"]`` adds each build."""

    def __init__(self, loader: NeighborSampler, limit: int, host):
        self.loader, self.limit, self.host = loader, limit, host

    def __len__(self):
        return min(len(self.loader), self.limit)

    def _build(self, graph):
        t0 = time.perf_counter()
        op = sage_aggregate(graph, "cpu")
        self.host["operator_seconds"] = \
            self.host.get("operator_seconds", 0.0) + time.perf_counter() - t0
        return op

    def __iter__(self):
        batches = self.loader.iter_host(self._build)
        try:
            for graph, op in itertools.islice(batches, len(self)):
                yield graph, {"aggregate": op}
        finally:
            batches.close()


def run(epochs: int = 1, batch_size: int = 512, seed: int = 0,
        max_batches: int = 20, device="cuda", data=None, capture=None):
    """Train and print the JAX script's line per epoch. ``data`` replaces
    ``Reddit(datasets_cache)[0]`` (N_FULL // 8 nodes). ``capture`` (see
    the module docstring) None means captured on a card and eager on the
    CPU; True elsewhere than a card raises. Returns the last validation
    accuracy, the mean loss of each epoch, each step's loss, the chance
    level, the run's seconds, the host's (``host_seconds``: the waits for
    the batches and their copies; ``host_collate_seconds``,
    ``host_operator_seconds``, ``host_copy_seconds``, ``host_batches``)
    and the model; a captured run adds what
    ``models/capture.py:captured_metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    if data is None:
        data = Reddit(str(PLANETOID_ROOT))[0]
    train, val, x_dev, y_dev = loaders(data, batch_size, seed, device=dev)
    num_classes = int(np.asarray(data.y).max()) + 1
    # the JAX script takes a first batch to shape the model, which draws
    # one epoch's order and one batch's samples from the loader's stream
    next(iter(train))
    model = SAGE(x_dev.shape[1], 128, num_classes,
                 generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                           capturable=dev.type == "cuda")
    host = {}
    statics = (StaticSampled(train, dev), StaticSampled(val, dev)) \
        if capture else None
    loop = StepLoop(
        (Sampled(train, max_batches, host),
         Sampled(val, max_batches // 2, host)), None,
        lambda graph, ops: train_step(model, opt, graph, x_dev, y_dev,
                                      ops["aggregate"]),
        lambda graph, ops: eval_step(model, graph, x_dev, y_dev,
                                     ops["aggregate"]),
        epochs, dev, capture, statics, host=host)
    epoch_losses, step_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        losses, (cor, tot) = loop.epoch()
        acc = cor / max(tot, 1.0)
        step_losses.append(losses)
        epoch_losses.append(float(np.mean(losses)))
        print(f"Epoch {epoch:02d}, Loss: {np.mean(losses):.4f}, "
              f"Val Acc: {acc:.4f}")
    return {"acc": acc, "epoch_losses": epoch_losses,
            "step_losses": np.stack(step_losses), "chance": 1.0 / num_classes,
            "seconds": time.perf_counter() - t0, "model": model,
            **{f"host_{k}": v for k, v in host.items()}, **loop.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=1)
    args = p.parse_args()
    run(args.epochs)
