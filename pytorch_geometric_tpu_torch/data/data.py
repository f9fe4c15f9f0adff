"""Host-side graph record — the mutable, numpy-backed ``Data``.

Mirrors the reference's ``torch_geometric.data.Data`` surface as used by
its scripts (reference: examples/gcn.py:12,24,46 — field access, keyword
iteration ``data('train_mask','val_mask','test_mask')``, ``.to(device)``),
but lives strictly on host: arrays are numpy, mutation is free, and the
jump to device happens exactly once, at collation into a padded
:class:`~pytorch_geometric_tpu_torch.data.graph.Graph`.

A copy of ``pytorch_geometric_tpu/data/data.py``: the port imports
nothing of the JAX package.
"""

import copy
from typing import Iterator, Tuple

import numpy as np


class Data:
    """An open-namespace host graph record.

    Standard keys: ``x`` (N, F), ``edge_index`` (2, E), ``edge_attr``
    (E, Fe), ``pos`` (N, D), ``y``, ``face`` (3, M), ``norm``, boolean
    masks.  Any other key is stored as-is (per-node if first dim == N).
    """

    def __init__(self, x=None, edge_index=None, edge_attr=None, y=None,
                 pos=None, **kwargs):
        self.x = _np(x)
        self.edge_index = _np(edge_index, dtype=np.int64)
        self.edge_attr = _np(edge_attr)
        self.y = _np(y)
        self.pos = _np(pos)
        for key, value in kwargs.items():
            setattr(self, key, _np(value))

    # --- namespace --------------------------------------------------------

    @property
    def keys(self):
        return [k for k, v in self.__dict__.items()
                if v is not None and not k.startswith("_")]

    def __contains__(self, key):
        return key in self.keys

    def __getitem__(self, key):
        return getattr(self, key, None)

    def __setitem__(self, key, value):
        setattr(self, key, _np(value))

    def __call__(self, *keys) -> Iterator[Tuple[str, np.ndarray]]:
        """Iterate (key, value) pairs, optionally filtered — matches the
        reference's ``for _, mask in data('train_mask', ...)`` idiom
        (examples/gcn.py:46)."""
        for key in sorted(self.keys):
            if not keys or key in keys:
                yield key, self[key]

    def __iter__(self):
        return self(*[])

    # --- shapes -----------------------------------------------------------

    @property
    def num_nodes(self):
        if getattr(self, "__num_nodes__", None) is not None:
            return self.__num_nodes__
        for key in ("x", "pos", "norm", "batch"):
            v = getattr(self, key, None)
            if v is not None:
                return v.shape[0]
        if self.edge_index is not None and self.edge_index.size:
            return int(self.edge_index.max()) + 1
        return 0

    @num_nodes.setter
    def num_nodes(self, n):
        self.__num_nodes__ = n

    @property
    def num_edges(self):
        return 0 if self.edge_index is None else self.edge_index.shape[1]

    @property
    def num_node_features(self):
        return 0 if self.x is None else (
            1 if self.x.ndim == 1 else self.x.shape[1])

    num_features = num_node_features

    @property
    def num_edge_features(self):
        return 0 if self.edge_attr is None else (
            1 if self.edge_attr.ndim == 1 else self.edge_attr.shape[1])

    @property
    def num_faces(self):
        face = getattr(self, "face", None)
        return 0 if face is None else face.shape[1]

    def is_node_level(self, key, value) -> bool:
        return (isinstance(value, np.ndarray) and value.ndim > 0
                and value.shape[0] == self.num_nodes
                and key not in ("edge_index", "edge_attr", "face"))

    def is_edge_level(self, key, value) -> bool:
        return key in ("edge_attr",) or (
            isinstance(value, np.ndarray) and value.ndim > 0
            and key not in ("edge_index",)
            and self.edge_index is not None
            and value.shape[0] == self.num_edges
            and value.shape[0] != self.num_nodes)

    # --- utilities --------------------------------------------------------

    def clone(self) -> "Data":
        return copy.deepcopy(self)

    def coalesce(self) -> "Data":
        """Sort edges by (receiver, sender) and merge duplicates (sums
        edge_attr) — reference torch-sparse ``coalesce``."""
        if self.edge_index is None or self.edge_index.size == 0:
            return self
        N = self.num_nodes
        key = self.edge_index[1] * N + self.edge_index[0]
        order = np.argsort(key, kind="stable")
        key = key[order]
        uniq, first = np.unique(key, return_index=True)
        ei = self.edge_index[:, order][:, first]
        if self.edge_attr is not None:
            ea = self.edge_attr[order]
            seg = np.searchsorted(uniq, key)
            out = np.zeros((uniq.shape[0],) + ea.shape[1:], dtype=ea.dtype)
            np.add.at(out, seg, ea)
            self.edge_attr = out
        self.edge_index = ei
        return self

    def to(self, device=None):
        """Device movement is a no-op on host Data (the reference's
        ``data.to(device)``, examples/gcn.py:32, maps to collation into a
        device Graph, ``from_data(data, device=...)``)."""
        return self

    def apply(self, fn, *keys):
        for key, value in self(*keys):
            setattr(self, key, fn(value))
        return self

    def __repr__(self):
        parts = []
        for key in sorted(self.keys):
            v = self[key]
            shape = list(v.shape) if isinstance(v, np.ndarray) else v
            parts.append(f"{key}={shape}")
        return f"Data({', '.join(parts)})"


def _np(value, dtype=None):
    if value is None:
        return None
    arr = np.asarray(value)
    if dtype is not None and arr.dtype != dtype:
        arr = arr.astype(dtype)
    return arr
