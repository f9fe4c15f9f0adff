"""Graclus coarsening levels computed on the host, once per sample.

Counterpart of ``pytorch_geometric_tpu/transforms/coarsen_levels.py``.
The reference coarsens inside the forward (graclus over normalised-cut
weights of ``pos``, examples/mnist_graclus.py), with shapes that change
every step. The weights depend on the geometry only, so the whole
hierarchy is computed at transform time: level k stores a ``cluster{k}``
node field mapping each original node to its representative's id (the
same id space, so batching offsets apply to it as to any node index).
The matching is the port's native ``graclus_cluster``.
"""

import numpy as np

from pytorch_geometric_tpu_torch.cluster import graclus_cluster


def _normalized_cut_np(senders, receivers, pos, num_nodes):
    d = np.linalg.norm(pos[senders] - pos[receivers], axis=1)
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return d * (inv[senders] + inv[receivers])


class PrecomputeGraclusCoarsening:
    """Adds the node fields ``cluster1`` .. ``cluster{levels}``; level k
    matches with seed ``seed + k``."""

    def __init__(self, levels: int = 2, seed: int = 0):
        self.levels = levels
        self.seed = seed

    def __call__(self, data):
        n = data.num_nodes
        s, r = data.edge_index[0].copy(), data.edge_index[1].copy()
        pos = data.pos.astype(np.float64)
        rep = np.arange(n, dtype=np.int64)   # each node's representative
        for level in range(1, self.levels + 1):
            w = _normalized_cut_np(s, r, pos, n)
            cl = graclus_cluster(s, r, w, num_nodes=n,
                                 seed=self.seed + level)
            rep = cl[rep]
            setattr(data, f"cluster{level}", rep.copy())
            # the coarse graph, in the original id space (id = rep id)
            s, r = cl[s], cl[r]
            keep = s != r
            s, r = s[keep], r[keep]
            _, first = np.unique(s * n + r, return_index=True)
            s, r = s[first], r[first]
            # a representative's position: the mean of its members'
            cnt = np.zeros(n)
            acc = np.zeros_like(pos)
            np.add.at(cnt, rep, 1.0)
            np.add.at(acc, rep, data.pos.astype(np.float64))
            pos = np.where(cnt[:, None] > 0,
                           acc / np.maximum(cnt, 1.0)[:, None], pos)
        return data

    def __repr__(self):
        return f"PrecomputeGraclusCoarsening(levels={self.levels})"
