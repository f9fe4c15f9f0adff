"""Structural transforms of host ``Data`` records, in numpy.

Counterpart of ``pytorch_geometric_tpu/transforms/structure.py``
(reference: ``ToDense``, examples/enzymes_diff_pool.py:25, the fixed-size
dense x / adj / mask of ``DenseDataLoader``; ``Constant``,
``AddSelfLoops``, ``OneHotDegree``).
"""

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data


class ToDense:
    """Densify to ``num_nodes`` rows: x (M, F), adj (M, M) with
    ``adj[receiver, sender]`` the edge's weight (a 1-d ``edge_attr``) or
    1, mask (M,); y and pos carried along."""

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes

    def __call__(self, data):
        m = self.num_nodes
        n = data.num_nodes
        adj = np.zeros((m, m), dtype=np.float32)
        w = data.edge_attr if data.edge_attr is not None and \
            data.edge_attr.ndim == 1 else None
        s, r = data.edge_index
        adj[r, s] = w if w is not None else 1.0
        out = Data()
        x = data.x if data.x is not None else np.ones((n, 1), np.float32)
        xp = np.zeros((m,) + x.shape[1:], dtype=np.float32)
        xp[:n] = x
        out.x = xp
        out.adj = adj
        mask = np.zeros(m, dtype=bool)
        mask[:n] = True
        out.mask = mask
        if data.y is not None:
            out.y = data.y
        if data.pos is not None:
            pp = np.zeros((m,) + data.pos.shape[1:], dtype=np.float32)
            pp[:n] = data.pos
            out.pos = pp
        return out

    def __repr__(self):
        return f"ToDense(num_nodes={self.num_nodes})"


class Constant:
    """Append a constant feature column (or replace x, with ``cat``
    false)."""

    def __init__(self, value: float = 1.0, cat: bool = True):
        self.value, self.cat = value, cat

    def __call__(self, data):
        c = np.full((data.num_nodes, 1), self.value, dtype=np.float32)
        if data.x is None or not self.cat:
            data.x = c
        else:
            data.x = np.concatenate(
                [data.x.reshape(data.num_nodes, -1), c], axis=-1)
        return data


class AddSelfLoops:
    """Drop the existing self loops, then add one per node."""

    def __call__(self, data):
        n = data.num_nodes
        loop = np.arange(n, dtype=data.edge_index.dtype)
        keep = data.edge_index[0] != data.edge_index[1]
        ei = data.edge_index[:, keep]
        data.edge_index = np.concatenate(
            [ei, np.stack([loop, loop])], axis=1)
        return data


class OneHotDegree:
    """Append the one-hot out-degree (in-degree with ``in_degree``),
    clipped at ``max_degree``."""

    def __init__(self, max_degree: int, in_degree: bool = False,
                 cat: bool = True):
        self.max_degree, self.in_degree, self.cat = max_degree, in_degree, \
            cat

    def __call__(self, data):
        idx = data.edge_index[1 if self.in_degree else 0]
        deg = np.bincount(idx, minlength=data.num_nodes)
        deg = np.clip(deg, 0, self.max_degree)
        oh = np.eye(self.max_degree + 1, dtype=np.float32)[deg]
        if data.x is not None and self.cat:
            data.x = np.concatenate(
                [data.x.reshape(data.num_nodes, -1), oh], axis=-1)
        else:
            data.x = oh
        return data
