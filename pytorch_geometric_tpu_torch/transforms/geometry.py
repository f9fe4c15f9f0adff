"""Geometric edge-attribute transforms on the host's numpy ``Data``.

Counterpart of ``pytorch_geometric_tpu/transforms/geometry.py``
(reference: ``Cartesian``, ``Distance``, ``Polar``, ``TargetIndegree``):
each writes pseudo-coordinates into ``edge_attr`` (after the existing
columns when ``cat``), normalised to [0, 1] when ``norm=True``. numpy
only, as in the JAX package.
"""

import numpy as np


def _cat(old, new):
    new = new.astype(np.float32)
    if old is None:
        return new
    old = old.reshape(old.shape[0], -1).astype(np.float32)
    return np.concatenate([old, new], axis=-1)


class Cartesian:
    def __init__(self, norm: bool = True, max_value=None, cat: bool = True):
        self.norm, self.max, self.cat = norm, max_value, cat

    def __call__(self, data):
        s, r = data.edge_index
        rel = data.pos[r] - data.pos[s]
        if self.norm and rel.size:
            scale = self.max if self.max is not None else \
                np.abs(rel).max()
            rel = rel / (2 * max(scale, 1e-12)) + 0.5
        data.edge_attr = _cat(data.edge_attr if self.cat else None, rel)
        return data

    def __repr__(self):
        return f"Cartesian(norm={self.norm})"


class Distance:
    def __init__(self, norm: bool = True, max_value=None, cat: bool = True):
        self.norm, self.max, self.cat = norm, max_value, cat

    def __call__(self, data):
        s, r = data.edge_index
        d = np.linalg.norm(data.pos[r] - data.pos[s], axis=-1,
                           keepdims=True)
        if self.norm and d.size:
            scale = self.max if self.max is not None else d.max()
            d = d / max(scale, 1e-12)
        data.edge_attr = _cat(data.edge_attr if self.cat else None, d)
        return data

    def __repr__(self):
        return f"Distance(norm={self.norm})"


class Polar:
    def __init__(self, norm: bool = True, max_value=None, cat: bool = True):
        self.norm, self.max, self.cat = norm, max_value, cat

    def __call__(self, data):
        s, r = data.edge_index
        rel = data.pos[r] - data.pos[s]
        rho = np.linalg.norm(rel, axis=-1, keepdims=True)
        theta = np.arctan2(rel[:, 1], rel[:, 0])[:, None]
        if self.norm and rho.size:
            scale = self.max if self.max is not None else rho.max()
            rho = rho / max(scale, 1e-12)
            theta = theta / (2 * np.pi) + 0.5
        data.edge_attr = _cat(data.edge_attr if self.cat else None,
                              np.concatenate([rho, theta], axis=-1))
        return data


class TargetIndegree:
    """edge_attr = normalised in-degree of the target node
    (examples/cora.py:11)."""

    def __init__(self, norm: bool = True, max_value=None, cat: bool = True):
        self.norm, self.max, self.cat = norm, max_value, cat

    def __call__(self, data):
        s, r = data.edge_index
        deg = np.bincount(r, minlength=data.num_nodes).astype(np.float32)
        w = deg[r]
        if self.norm and w.size:
            scale = self.max if self.max is not None else w.max()
            w = w / max(scale, 1e-12)
        data.edge_attr = _cat(data.edge_attr if self.cat else None,
                              w[:, None])
        return data

    def __repr__(self):
        return f"TargetIndegree(norm={self.norm})"
