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
the host): the ``spmm_csr`` kernel on a card. The VGAE's noise is drawn
from a ``torch.Generator`` seeded from ``seed``; AUC and AP are the
port's numpy versions of sklearn's.
"""

import argparse
import time

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn.conv import GCNConv
from pytorch_geometric_tpu_torch.nn.models import (
    GAE, VGAE, negative_sampling, split_edges)
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


def loss_of(ae, enc, graph, pos, neg, aggregate_fn, generator=None,
            noise=None):
    """The JAX script's loss: the reconstruction loss over the train
    positives ``pos`` and the negatives ``neg``, plus the KL term over N
    for the VGAE (its noise from ``generator``, or ``noise``)."""
    if isinstance(ae, VGAE):
        mu, logstd = enc(graph, graph.x, aggregate_fn)
        z = ae.reparametrize(mu, logstd, generator, noise=noise)
        return ae.recon_loss(z, *pos, *neg) + \
            ae.kl_loss(mu, logstd) / graph.num_nodes
    return ae.recon_loss(enc(graph, graph.x, aggregate_fn), *pos, *neg)


def run(variational: bool = False, epochs: int = 100, seed: int = 0,
        device="cuda", loaded=None):
    """Train and print the JAX script's line every 20 epochs. ``loaded``
    (data, graph) replaces :func:`load`'s. Returns the last AUC and AP,
    every epoch's loss, the operator's host seconds and the run's
    seconds."""
    dev = resolve_device(device)
    data, graph = loaded or load(seed, device=dev)
    t0 = time.perf_counter()
    op, weights = gcn_spmm_operator(graph)
    aggregate_fn = op.bind(weights)
    operator_seconds = time.perf_counter() - t0
    enc = Encoder(graph.num_node_features, variational=variational,
                  generator=torch.Generator().manual_seed(seed)).to(dev)
    ae = VGAE(enc) if variational else GAE(enc)
    pos = edges(data.train_pos_edge_index, dev)
    neg_s, neg_r = negative_sampling(
        data.train_pos_edge_index[0], data.train_pos_edge_index[1],
        data.num_nodes, pos[0].shape[0], seed=seed + 1)
    neg = (torch.from_numpy(neg_s).to(dev), torch.from_numpy(neg_r).to(dev))
    test = edges(data.test_pos_edge_index, dev) + \
        edges(data.test_neg_edge_index, dev)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01)
    noise = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    auc = ap = None
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        opt.zero_grad(set_to_none=True)
        loss = loss_of(ae, enc, graph, pos, neg, aggregate_fn, noise)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            with torch.no_grad():
                z = enc(graph, graph.x, aggregate_fn)
            if variational:
                z = z[0]
            auc, ap = ae.test(z, *test)
            print(f"Epoch {epoch:03d}, Loss {float(losses[-1]):.4f}, "
                  f"AUC: {auc:.4f}, AP: {ap:.4f}")
    return {"auc": auc, "ap": ap,
            "losses": torch.stack(losses).cpu().numpy(),
            "operator_seconds": operator_seconds,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--variational", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    args = p.parse_args()
    run(args.variational, args.epochs)
