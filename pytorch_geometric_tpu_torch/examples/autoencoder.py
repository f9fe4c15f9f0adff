"""GAE / VGAE link prediction on Cora: the port's counterpart of
examples/autoencoder.py. ``split_edges`` (5% val, 10% test positives and
as many sampled negatives; the train positives both ways become the
graph's edges); a GCN encoder 1433 -> 32 (ReLU) -> 16 (``conv_mu``, and
``conv_logstd`` with ``--variational``); the inner-product decoder's
reconstruction loss over the train positives and one fixed set of
sampled negatives (plus the KL term / N for the VGAE); Adam 0.01, 100
epochs; AUC and AP on the test edges every 20.

    python -m pytorch_geometric_tpu_torch.examples.autoencoder [--variational]

Every GCN aggregation runs through the ``SpmmOperator`` of the graph's
``gcn_edge_set`` (``models/citation.py:gcn_spmm_operator``, built once on
the host): the ``spmm_csr`` kernel on a card. The decoder gathers the
embeddings at the train positives' and the negatives' ends through a
``SortedSegmentSum`` of each index list (:func:`gathers`, built once on
the host), whose backward sums in a fixed order through the segment-sum
kernel, so that two runs are bitwise equal. The VGAE's noise is drawn
from a ``torch.Generator`` seeded from ``seed``; AUC and AP are the
port's numpy versions of sklearn's.

The JAX script jits its epoch. Here, on a card, the epoch (forward,
backward, Adam) is a CUDA graph captured once and replayed up to each
test (``models/capture.py:EpochSpans``, ``capture=None`` or ``True``),
the VGAE's noise drawn inside it from the generator registered with the
graph; the tests run eagerly between the spans. ``capture=False`` runs
the same epochs from Python (the CPU's only mode).
"""

import argparse
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    EpochSpans, resolve_capture)
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn.conv import GCNConv
from pytorch_geometric_tpu_torch.nn.models import (
    GAE, VGAE, negative_sampling, split_edges)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures


class Encoder(nn.Module):
    """examples/autoencoder.py's ``Encoder``: ``conv1``, ``conv_mu`` and,
    variational, ``conv_logstd``."""

    def __init__(self, in_channels: int, out: int = 16,
                 variational: bool = False, generator=None):
        super().__init__()
        self.variational = variational
        self.conv1 = GCNConv(in_channels, 2 * out, generator=generator)
        self.conv_mu = GCNConv(2 * out, out, generator=generator)
        if variational:
            self.conv_logstd = GCNConv(2 * out, out, generator=generator)

    def forward(self, graph, x, aggregate_fn=None):
        x = torch.relu(self.conv1(graph, x, aggregate_fn=aggregate_fn))
        mu = self.conv_mu(graph, x, aggregate_fn=aggregate_fn)
        if not self.variational:
            return mu
        return mu, self.conv_logstd(graph, x, aggregate_fn=aggregate_fn)


def load(seed: int = 0, root=PLANETOID_ROOT, device="cuda"):
    """``(data, graph)``: Cora under ``root`` through
    ``NormalizeFeatures``, its edges split from ``seed`` (host ``Data``),
    and the graph of the train positives on ``device``."""
    ds = Planetoid(str(root), "Cora", transform=NormalizeFeatures())
    data = split_edges(ds[0].clone(), seed=seed)
    return data, from_data(data, device=device)


def edges(index, device):
    """A host (2, E) edge index as two tensors on ``device``."""
    t = torch.as_tensor(index, dtype=torch.int64, device=device)
    return t[0], t[1]


def gathers(senders, receivers, num_nodes, device):
    """The decoder's gathers at an edge list's two ends: a
    ``SortedSegmentSum`` of each index list (``nn/models/autoencoder.py:
    _rows``)."""
    return tuple(SortedSegmentSum(i, num_nodes, device=device)
                 for i in (senders, receivers))


def loss_of(ae, enc, graph, pos, neg, aggregate_fn, generator=None,
            noise=None):
    """The JAX script's loss: the reconstruction loss over the train
    positives ``pos`` and the negatives ``neg`` (index tensors or their
    :func:`gathers`), plus the KL term over N for the VGAE (its noise
    from ``generator``, or ``noise``)."""
    if isinstance(ae, VGAE):
        mu, logstd = enc(graph, graph.x, aggregate_fn)
        z = ae.reparametrize(mu, logstd, generator, noise=noise)
        return ae.recon_loss(z, *pos, *neg) + \
            ae.kl_loss(mu, logstd) / graph.num_nodes
    return ae.recon_loss(enc(graph, graph.x, aggregate_fn), *pos, *neg)


def run(variational: bool = False, epochs: int = 100, seed: int = 0,
        device="cuda", loaded=None, capture=None):
    """Train and print the JAX script's line every 20 epochs. ``loaded``
    (data, graph) replaces :func:`load`'s; ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU, True
    elsewhere than a card raises. Returns the last AUC and AP, every
    epoch's loss, the operators' host seconds (the GCN's and the
    decoder's gathers), the run's seconds, the encoder, its
    ``EpochSpans`` (``spans``) and what ``EpochSpans.metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    data, graph = loaded or load(seed, device=dev)
    pos_s, pos_r = data.train_pos_edge_index
    neg_s, neg_r = negative_sampling(pos_s, pos_r, data.num_nodes,
                                     len(pos_s), seed=seed + 1)
    t0 = time.perf_counter()
    op, weights = gcn_spmm_operator(graph)
    aggregate_fn = op.bind(weights)
    pos = gathers(pos_s, pos_r, graph.num_nodes, dev)
    neg = gathers(neg_s, neg_r, graph.num_nodes, dev)
    operator_seconds = time.perf_counter() - t0
    enc = Encoder(graph.num_node_features, variational=variational,
                  generator=torch.Generator().manual_seed(seed)).to(dev)
    ae = VGAE(enc) if variational else GAE(enc)
    test = edges(data.test_pos_edge_index, dev) + \
        edges(data.test_neg_edge_index, dev)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01,
                           capturable=dev.type == "cuda")
    noise = torch.Generator(device=dev).manual_seed(seed)

    def epoch_step():
        opt.zero_grad(set_to_none=False)
        loss = loss_of(ae, enc, graph, pos, neg, aggregate_fn, noise)
        loss.backward()
        opt.step()
        return loss.detach()

    def evaluate():
        with torch.no_grad():
            z = enc(graph, graph.x, aggregate_fn)
        return ae.test(z[0] if variational else z, *test)

    spans = EpochSpans(epoch_step, epochs, dev, capture,
                       noise if variational else None)
    losses = []
    auc = ap = None
    t0 = time.perf_counter()
    while spans.epochs < epochs:
        losses.extend(spans.span(min(20, epochs - spans.epochs))[:, 0])
        if spans.epochs % 20 == 0:
            auc, ap = spans.between(evaluate)
            print(f"Epoch {spans.epochs:03d}, Loss {losses[-1]:.4f}, "
                  f"AUC: {auc:.4f}, AP: {ap:.4f}")
    return {"auc": auc, "ap": ap, "losses": np.asarray(losses),
            "operator_seconds": operator_seconds,
            "run_seconds": time.perf_counter() - t0, "model": enc,
            "spans": spans, **spans.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--variational", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    args = p.parse_args()
    run(args.variational, args.epochs)
