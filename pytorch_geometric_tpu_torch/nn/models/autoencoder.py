"""Graph autoencoders.

Counterpart of ``pytorch_geometric_tpu/nn/models/autoencoder.py``
(reference: ``torch_geometric.nn.GAE`` / ``VGAE``;
examples/autoencoder.py:8,43-65, ``split_edges``, ``recon_loss``,
``kl_loss``, ``test`` returning (AUC, AP)).

Host and device, as in the JAX package: ``split_edges`` and
``negative_sampling`` are host numpy, the JAX code's, so one seed draws
the same edges in both packages; encoding, decoding and the losses are
torch. ``VGAE.reparametrize`` draws its noise from the caller's
``torch.Generator``. ``GAE.test`` scores with :func:`roc_auc_score` and
:func:`average_precision_score`, numpy versions of sklearn's (ties
handled as sklearn handles them), since the card's machine has no
sklearn.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum

EPS = 1e-15


def _rows(z, index):
    """``z``'s rows at ``index``: an index tensor, or a
    ``SortedSegmentSum`` over the indices, whose gather sums its backward
    in a fixed order through the segment-sum kernel (torch's gather
    backward scatters with atomics, whose order varies from run to run
    on a card)."""
    if isinstance(index, SortedSegmentSum):
        return index.gather(z)
    return z.index_select(0, index.long())


class InnerProductDecoder:
    """sigma(z_i . z_j) edge probabilities. ``senders`` and ``receivers``
    are index tensors or their ``SortedSegmentSum`` (:func:`_rows`)."""

    def __call__(self, z, senders, receivers, sigmoid: bool = True):
        value = (_rows(z, senders) * _rows(z, receivers)).sum(-1)
        return torch.sigmoid(value) if sigmoid else value

    def forward_all(self, z, sigmoid: bool = True):
        adj = z @ z.T
        return torch.sigmoid(adj) if sigmoid else adj


def negative_sampling(senders, receivers, num_nodes, num_neg,
                      seed: int = 0):
    """Sample edges absent from the graph (host numpy)."""
    rng = np.random.default_rng(seed)
    existing = set((int(s) * num_nodes + int(r))
                   for s, r in zip(host_array(senders),
                                   host_array(receivers)))
    out_s, out_r = [], []
    while len(out_s) < num_neg:
        cand_s = rng.integers(0, num_nodes, size=num_neg)
        cand_r = rng.integers(0, num_nodes, size=num_neg)
        for s, r in zip(cand_s, cand_r):
            if s != r and (int(s) * num_nodes + int(r)) not in existing:
                out_s.append(int(s))
                out_r.append(int(r))
                if len(out_s) == num_neg:
                    break
    return (np.asarray(out_s, dtype=np.int64),
            np.asarray(out_r, dtype=np.int64))


def split_edges(data: Data, val_ratio: float = 0.05,
                test_ratio: float = 0.1, seed: int = 0) -> Data:
    """Reference ``GAE.split_edges`` semantics
    (examples/autoencoder.py:43): keep one direction of each undirected
    edge, split into train/val/test positive sets, sample negative
    val/test edges, and store train_pos edges both directions."""
    rng = np.random.default_rng(seed)
    ei = np.asarray(data.edge_index)
    n = data.num_nodes
    mask = ei[0] < ei[1]
    s, r = ei[0][mask], ei[1][mask]
    perm = rng.permutation(len(s))
    s, r = s[perm], r[perm]

    n_v = int(np.floor(val_ratio * len(s)))
    n_t = int(np.floor(test_ratio * len(s)))
    data.val_pos_edge_index = np.stack([s[:n_v], r[:n_v]])
    data.test_pos_edge_index = np.stack([s[n_v:n_v + n_t],
                                         r[n_v:n_v + n_t]])
    tr_s, tr_r = s[n_v + n_t:], r[n_v + n_t:]
    data.train_pos_edge_index = np.stack(
        [np.concatenate([tr_s, tr_r]), np.concatenate([tr_r, tr_s])])

    neg_s, neg_r = negative_sampling(ei[0], ei[1], n, n_v + n_t, seed)
    data.val_neg_edge_index = np.stack([neg_s[:n_v], neg_r[:n_v]])
    data.test_neg_edge_index = np.stack([neg_s[n_v:], neg_r[n_v:]])
    data.edge_index = data.train_pos_edge_index
    return data


def _ranks(a):
    """1-based ranks of ``a``, ties given their average rank."""
    order = np.argsort(a, kind="mergesort")
    sorted_a = a[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_a)) + 1]
    ends = np.r_[starts[1:], a.size]
    avg = (starts + ends + 1) / 2.0          # mean of ranks start+1..end
    ranks = np.empty(a.size, dtype=np.float64)
    ranks[order] = np.repeat(avg, ends - starts)
    return ranks


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels, ties counted one half:
    sklearn's ``roc_auc_score`` (the Mann-Whitney statistic)."""
    y = np.asarray(y_true).astype(bool)
    score = np.asarray(y_score, dtype=np.float64)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score needs both classes")
    ranks = _ranks(score)
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def average_precision_score(y_true, y_score) -> float:
    """sklearn's ``average_precision_score``: sum over the distinct
    thresholds, highest first, of (R_n - R_{n-1}) P_n, tied scores one
    threshold."""
    y = np.asarray(y_true).astype(np.float64)
    score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(score)), y.size - 1]
    tps = np.cumsum(y)[last]
    fps = 1 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


class GAE:
    """Non-variational graph autoencoder over an encoder callable."""

    def __init__(self, encoder_apply: Callable,
                 decoder: Optional[InnerProductDecoder] = None):
        self.encode = encoder_apply
        self.decoder = decoder or InnerProductDecoder()

    def recon_loss(self, z, pos_senders, pos_receivers,
                   neg_senders=None, neg_receivers=None, seed: int = 0):
        pos = self.decoder(z, pos_senders, pos_receivers)
        pos_loss = -torch.log(pos + EPS).mean()
        if neg_senders is None:
            neg_s, neg_r = negative_sampling(
                pos_senders, pos_receivers, z.shape[0],
                int(pos_senders.shape[0]), seed)
            neg_senders = torch.from_numpy(neg_s).to(z.device)
            neg_receivers = torch.from_numpy(neg_r).to(z.device)
        neg = self.decoder(z, neg_senders, neg_receivers)
        neg_loss = -torch.log(1.0 - neg + EPS).mean()
        return pos_loss + neg_loss

    def test(self, z, pos_senders, pos_receivers, neg_senders,
             neg_receivers) -> Tuple[float, float]:
        """(AUC, AP) over positive/negative edge sets
        (examples/autoencoder.py:65)."""
        with torch.no_grad():
            pos = host_array(self.decoder(z, pos_senders, pos_receivers))
            neg = host_array(self.decoder(z, neg_senders, neg_receivers))
        y = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
        pred = np.concatenate([pos, neg])
        return roc_auc_score(y, pred), average_precision_score(y, pred)


class VGAE(GAE):
    """Variational GAE: the encoder returns (mu, logstd)."""

    MAX_LOGSTD = 10.0

    def reparametrize(self, mu, logstd, rng: Optional[torch.Generator] = None,
                      training: bool = True, noise=None):
        """``mu + noise * exp(logstd)``, the noise a standard normal drawn
        from ``rng`` (or given as ``noise``); ``mu`` when not
        ``training``."""
        if not training:
            return mu
        logstd = logstd.clamp(max=self.MAX_LOGSTD)
        if noise is None:
            noise = torch.randn(mu.shape, generator=rng, device=mu.device)
        return mu + noise * torch.exp(logstd)

    def kl_loss(self, mu, logstd):
        logstd = logstd.clamp(max=self.MAX_LOGSTD)
        return -0.5 * torch.mean(torch.sum(
            1 + 2 * logstd - mu ** 2 - torch.exp(logstd) ** 2, dim=1))
