"""Large single-graph corpora: ``Reddit`` and ``Amazon`` (Computers,
Photo).

Counterpart of ``pytorch_geometric_tpu/datasets/large_graphs.py``
(reference: ``torch_geometric.datasets.Reddit`` and ``Amazon``). No
download is attempted and nothing is written under ``root``:

- ``Reddit``: ``<root>/reddit/raw/reddit_data.npz`` (``feature``,
  ``label``, ``node_types``: 1 train, 2 val, 3 test) with
  ``reddit_graph.npz`` (a scipy sparse adjacency), the GraphSAGE
  release; otherwise a planted-partition graph with the published
  shapes, the JAX package's draws: 1/8 of the 232,965 nodes by default,
  all of them with ``full_scale=True``, 602 features, 41 classes, 25
  edge draws a node, each kept edge in both directions (~11.6 M
  directed edges at full scale, against the release's 114.6 M).
- ``Amazon``: ``<root>/amazon/<name>/raw/amazon_electronics_<name>.npz``
  (the CSR triplets of the adjacency and the attributes, and the labels),
  loaded without unpickling anything; otherwise the planted-partition
  graph of the corpus's shapes.
"""

import os.path as osp

import numpy as np
import scipy.sparse as sp

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset


def _planted_graph(n, e_per_node, f, c, seed, label_dtype=np.int64):
    """``(edge_index, x, labels)`` of a planted-partition graph: ``n *
    e_per_node`` draws, 70% to a node of a nearby label rank, self loops
    dropped, each kept edge in both directions; features with a class
    signal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, size=n)
    e = n * e_per_node
    src = rng.integers(0, n, size=e)
    order = np.argsort(labels, kind="stable")
    rank_of = np.empty(n, dtype=np.int64)
    rank_of[order] = np.arange(n)
    half = max(n // c // 2, 1)
    jitter = rng.integers(-half, half, size=e)
    dst = order[np.clip(rank_of[src] + jitter, 0, n - 1)]
    rand = rng.random(e) > 0.7
    dst[rand] = rng.integers(0, n, size=int(rand.sum()))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    x = rng.normal(size=(n, f)).astype(np.float32)
    x += np.eye(c, dtype=np.float32)[labels] @ \
        rng.normal(size=(c, f)).astype(np.float32) * 0.5
    return ei, x, labels.astype(label_dtype)


class Reddit(InMemoryDataset):
    N_FULL, F, C = 232965, 602, 41

    def __init__(self, root, transform=None, pre_transform=None,
                 full_scale: bool = False):
        self.full_scale = full_scale
        self.is_synthetic = False
        super().__init__(osp.join(root, "reddit"), transform, pre_transform)

    @property
    def raw_file_names(self):
        return ["reddit_data.npz", "reddit_graph.npz"]

    def process_full(self):
        if osp.exists(self.raw_paths[0]):
            with np.load(self.raw_paths[0]) as data:
                x = data["feature"].astype(np.float32)
                y = data["label"].astype(np.int64)
                split = data["node_types"]
            adj = sp.load_npz(self.raw_paths[1]).tocoo()
            return [Data(x=x, edge_index=np.stack([adj.row, adj.col])
                         .astype(np.int64), y=y,
                         train_mask=split == 1, val_mask=split == 2,
                         test_mask=split == 3)]
        self.is_synthetic = True
        n = self.N_FULL if self.full_scale else self.N_FULL // 8
        ei, x, y = _planted_graph(n, 25, self.F, self.C, seed=7)
        split = np.random.default_rng(8).random(n)
        return [Data(x=x, edge_index=ei, y=y, train_mask=split < 0.66,
                     val_mask=(split >= 0.66) & (split < 0.76),
                     test_mask=split >= 0.76)]


class Amazon(InMemoryDataset):
    SHAPES = {"computers": (13752, 767, 10), "photo": (7650, 745, 8)}

    def __init__(self, root, name, transform=None, pre_transform=None):
        self.name = name.lower()
        if self.name not in self.SHAPES:
            raise ValueError(f"unknown Amazon corpus {name!r}; expected one "
                             f"of {sorted(self.SHAPES)}")
        self.is_synthetic = False
        super().__init__(osp.join(root, "amazon", self.name), transform,
                         pre_transform)

    @property
    def raw_file_names(self):
        return [f"amazon_electronics_{self.name}.npz"]

    def process_full(self):
        if osp.exists(self.raw_paths[0]):
            with np.load(self.raw_paths[0]) as fz:
                adj = sp.csr_matrix((fz["adj_data"], fz["adj_indices"],
                                     fz["adj_indptr"]),
                                    shape=fz["adj_shape"]).tocoo()
                attr = sp.csr_matrix((fz["attr_data"], fz["attr_indices"],
                                      fz["attr_indptr"]),
                                     shape=fz["attr_shape"])
                x = np.asarray(attr.todense(), dtype=np.float32)
                y = fz["labels"].astype(np.int64)
            return [Data(x=x, edge_index=np.stack([adj.row, adj.col])
                         .astype(np.int64), y=y)]
        self.is_synthetic = True
        n, f, c = self.SHAPES[self.name]
        ei, x, y = _planted_graph(n, 18, f, c, seed=11)
        return [Data(x=x, edge_index=ei, y=y)]
