"""Undirected-graph helpers on the host, at load time (counterpart of
``pytorch_geometric_tpu/utils/undirected.py``; reference:
torch_geometric.utils.to_undirected). numpy in, numpy out."""

import numpy as np


def _num_nodes(senders, receivers, num_nodes):
    if num_nodes:
        return num_nodes
    return int(max(senders.max(), receivers.max())) + 1 if senders.size \
        else 0


def to_undirected(senders, receivers, num_nodes=None):
    """Both directions of every edge, each (sender, receiver) pair once,
    in ascending order of ``sender * N + receiver``."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    n = _num_nodes(senders, receivers, num_nodes)
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    key = s.astype(np.int64) * n + r
    _, first = np.unique(key, return_index=True)
    return s[first], r[first]


def is_undirected(senders, receivers, num_nodes=None) -> bool:
    """Whether every edge's reverse is an edge too."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    n = _num_nodes(senders, receivers, num_nodes)
    fwd = set((senders.astype(np.int64) * n + receivers).tolist())
    bwd = set((receivers.astype(np.int64) * n + senders).tolist())
    return fwd == bwd
