"""Planetoid citation datasets: Cora / CiteSeer / PubMed.

Counterpart of ``pytorch_geometric_tpu/datasets/planetoid.py``
(reference: ``torch_geometric.datasets.Planetoid``). Resolution order:

1. raw Planetoid files (``ind.<name>.{x,tx,allx,y,ty,ally,graph,
   test.index}``) under ``<root>/<name>/raw/``, parsed exactly as the JAX
   package parses them;
2. otherwise the deterministic synthetic graph with the corpus's shapes
   (``datasets/synthetic.py``), flagged via ``dataset.is_synthetic``.

No download is attempted and nothing is written under ``root``.
"""

import os.path as osp
import pickle

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset
from pytorch_geometric_tpu_torch.datasets.synthetic import (
    synthetic_citation_graph)

_PARTS = ["x", "tx", "allx", "y", "ty", "ally", "graph", "test.index"]


class Planetoid(InMemoryDataset):

    def __init__(self, root, name, transform=None, pre_transform=None):
        self.name = name.lower()
        self.is_synthetic = False
        super().__init__(osp.join(root, name), transform, pre_transform)

    @property
    def raw_file_names(self):
        return [f"ind.{self.name}.{p}" for p in _PARTS]

    def process_full(self):
        if all(osp.exists(p) for p in self.raw_paths):
            return [self._parse_planetoid()]
        self.is_synthetic = True
        return [synthetic_citation_graph(self.name)]

    def _parse_planetoid(self) -> Data:
        objs = {}
        for part in _PARTS[:-1]:
            path = osp.join(self.raw_dir, f"ind.{self.name}.{part}")
            with open(path, "rb") as f:
                # the public Planetoid files are Python 2 pickles of
                # scipy sparse matrices, numpy arrays and a dict
                objs[part] = pickle.load(f, encoding="latin1")
        test_idx = np.loadtxt(
            osp.join(self.raw_dir, f"ind.{self.name}.test.index"),
            dtype=np.int64)

        x, tx, allx = (np.asarray(objs[k].todense(), dtype=np.float32)
                       for k in ("x", "tx", "allx"))
        y, ty, ally = (np.asarray(objs[k]) for k in ("y", "ty", "ally"))
        test_sorted = np.sort(test_idx)

        if self.name == "citeseer":
            # citeseer has isolated test nodes missing from tx; re-insert.
            full = np.arange(test_sorted[0], test_sorted[-1] + 1)
            tx_ext = np.zeros((len(full), tx.shape[1]), dtype=np.float32)
            tx_ext[test_sorted - test_sorted[0]] = tx
            ty_ext = np.zeros((len(full), ty.shape[1]), dtype=ty.dtype)
            ty_ext[test_sorted - test_sorted[0]] = ty
            tx, ty, test_idx_used = tx_ext, ty_ext, full
        else:
            test_idx_used = test_sorted

        # Canonical planetoid reordering: test rows of allx||tx are stored
        # contiguously after allx but belong at positions test_idx_used.
        features = np.vstack([allx, tx])
        labels = np.vstack([ally, ty])
        features = _reorder(features, test_idx_used, allx.shape[0])
        labels = _reorder(labels, test_idx_used, ally.shape[0])

        y_int = labels.argmax(axis=1).astype(np.int64)
        n = features.shape[0]

        graph = objs["graph"]
        rows, cols = [], []
        for src, nbrs in graph.items():
            rows.extend([src] * len(nbrs))
            cols.extend(nbrs)
        ei = np.stack([np.asarray(rows, dtype=np.int64),
                       np.asarray(cols, dtype=np.int64)])
        # undirected + dedup + no self loops
        ei = np.concatenate([ei, ei[::-1]], axis=1)
        ei = ei[:, ei[0] != ei[1]]
        key = ei[0] * n + ei[1]
        _, first = np.unique(key, return_index=True)
        ei = ei[:, first]

        train_mask = np.zeros(n, dtype=bool)
        train_mask[: y.shape[0]] = True
        val_mask = np.zeros(n, dtype=bool)
        val_mask[y.shape[0]: y.shape[0] + 500] = True
        test_mask = np.zeros(n, dtype=bool)
        test_mask[test_idx] = True

        return Data(x=features, edge_index=ei, y=y_int,
                    train_mask=train_mask, val_mask=val_mask,
                    test_mask=test_mask)


def _reorder(mat, test_idx, offset):
    out = mat.copy()
    out[test_idx] = mat[offset: offset + len(test_idx)]
    return out
