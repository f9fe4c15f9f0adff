"""PPI: inductive multi-label node classification over 24 protein
interaction graphs.

Counterpart of ``pytorch_geometric_tpu/datasets/ppi.py`` (reference:
``torch_geometric.datasets.PPI``; examples/ppi.py:11-16, split train /
val / test loaders, BCE multi-label training, micro-F1). Resolution
order, under ``<root>/ppi/<split>/raw/``:

1. the GraphSAGE release: ``<split>_graph.json`` (networkx node-link
   links), ``<split>_feats.npy``, ``<split>_labels.npy``,
   ``<split>_graph_id.npy`` (the val split's files are named ``valid``),
   parsed as the JAX package parses them: each graph's nodes, the links
   inside it in both directions, each (sender, receiver) pair once;
2. otherwise the deterministic synthetic graphs with the corpus's shapes,
   the JAX package's generator draw for draw (:func:`_synthetic_ppi`),
   flagged via ``dataset.is_synthetic``: 20 / 2 / 2 graphs of ~2300
   nodes, 50 features, 121 labels. Their edges are random pairs in both
   directions, so a pair may repeat (~0.6% of the edges).

No download is attempted and nothing is written under ``root``.
"""

import json
import os.path as osp

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset


def _synthetic_ppi(split: str, seed: int = 0):
    counts = {"train": 20, "val": 2, "test": 2}[split]
    rng = np.random.default_rng(seed + {"train": 0, "val": 1,
                                        "test": 2}[split])
    out = []
    for g in range(counts):
        n = int(rng.normal(2300, 300))
        e = n * 14
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
        keep = src != dst
        ei = np.stack([np.concatenate([src[keep], dst[keep]]),
                       np.concatenate([dst[keep], src[keep]])])
        x = rng.normal(size=(n, 50)).astype(np.float32)
        # correlated multi-labels so BCE training is meaningful
        w = rng.normal(size=(50, 121)).astype(np.float32)
        y = ((x @ w) > 0.5).astype(np.float32)
        out.append(Data(x=x, edge_index=ei, y=y))
    return out


class PPI(InMemoryDataset):

    def __init__(self, root, split: str = "train", transform=None,
                 pre_transform=None, pre_filter=None):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split must be train, val or test, got "
                             f"{split!r}")
        self.split = split
        self.is_synthetic = False
        super().__init__(osp.join(root, "ppi", split), transform,
                         pre_transform, pre_filter)

    @property
    def raw_file_names(self):
        s = {"val": "valid"}.get(self.split, self.split)
        return [f"{s}_graph.json", f"{s}_feats.npy", f"{s}_labels.npy",
                f"{s}_graph_id.npy"]

    def process_full(self):
        if not osp.exists(self.raw_paths[0]):
            self.is_synthetic = True
            return _synthetic_ppi(self.split)
        with open(self.raw_paths[0]) as f:
            graph = json.load(f)
        feats = np.load(self.raw_paths[1]).astype(np.float32)
        labels = np.load(self.raw_paths[2]).astype(np.float32)
        graph_id = np.load(self.raw_paths[3])
        src = np.asarray([link["source"] for link in graph["links"]])
        dst = np.asarray([link["target"] for link in graph["links"]])
        out = []
        for gid in np.unique(graph_id):
            nodes = np.flatnonzero(graph_id == gid)
            lo, hi = nodes.min(), nodes.max() + 1
            m = (src >= lo) & (src < hi) & (dst >= lo) & (dst < hi)
            ei = np.stack([src[m] - lo, dst[m] - lo])
            ei = np.concatenate([ei, ei[::-1]], axis=1)
            key = ei[0] * (hi - lo) + ei[1]
            _, first = np.unique(key, return_index=True)
            out.append(Data(x=feats[lo:hi], edge_index=ei[:, first],
                            y=labels[lo:hi]))
        return out
