"""TUDataset: graph-classification corpora (ENZYMES, MUTAG, ...).

Counterpart of ``pytorch_geometric_tpu/datasets/tu_dataset.py``
(reference: ``torch_geometric.datasets.TUDataset``;
examples/mutag_gin.py:11-13, examples/enzymes_topk_pool.py,
enzymes_diff_pool.py). Resolution order, under ``<root>/<name>/raw/``:

1. the TU text format (``<name>_A.txt``, ``<name>_graph_indicator.txt``,
   ``<name>_graph_labels.txt``, optional node labels, node attributes and
   edge labels), parsed as the JAX package parses it (:meth:`_parse_tu`);
2. otherwise the deterministic synthetic corpus with the canonical
   statistics of ``_CANONICAL`` (``synthetic_graph_classification``,
   seed 42), flagged via ``dataset.is_synthetic``.

No download is attempted and nothing is written under ``root``.
"""

import os.path as osp

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset
from pytorch_geometric_tpu_torch.datasets.synthetic import (
    synthetic_graph_classification)

_CANONICAL = {
    # name: (num_graphs, avg_nodes, num_node_labels, num_classes)
    "ENZYMES": (600, 33, 3, 6),
    "MUTAG": (188, 18, 7, 2),
    "PROTEINS": (1113, 39, 3, 2),
    "DD": (1178, 284, 89, 2),
    "COLLAB": (5000, 74, 0, 3),
    "IMDB-BINARY": (1000, 20, 0, 2),
}


class TUDataset(InMemoryDataset):

    def __init__(self, root, name, transform=None, pre_transform=None,
                 pre_filter=None, use_node_attr: bool = False):
        self.name = name
        self.use_node_attr = use_node_attr
        self.is_synthetic = False
        super().__init__(osp.join(root, name), transform, pre_transform,
                         pre_filter)

    @property
    def raw_file_names(self):
        return [f"{self.name}_A.txt",
                f"{self.name}_graph_indicator.txt",
                f"{self.name}_graph_labels.txt"]

    def process_full(self):
        if not osp.exists(self.raw_paths[0]):
            self.is_synthetic = True
            g, n, labels, c = _CANONICAL.get(self.name, (200, 25, 3, 2))
            return synthetic_graph_classification(
                g, n, max(labels, 1), c, seed=42,
                num_node_labels=labels if labels > 0 else None)
        return self._parse_tu()

    def _parse_tu(self):
        pre = osp.join(self.raw_dir, self.name + "_")
        edges = np.loadtxt(pre + "A.txt", delimiter=",",
                           dtype=np.int64) - 1   # 1-based
        graph_of = np.loadtxt(pre + "graph_indicator.txt",
                              dtype=np.int64) - 1
        y = np.loadtxt(pre + "graph_labels.txt", dtype=np.int64)
        # labels remapped to 0..C-1
        _, y = np.unique(y, return_inverse=True)

        node_labels = None
        if osp.exists(pre + "node_labels.txt"):
            nl = np.loadtxt(pre + "node_labels.txt", delimiter=",",
                            dtype=np.int64)
            if nl.ndim == 1:
                _, nl = np.unique(nl, return_inverse=True)
                node_labels = np.eye(nl.max() + 1, dtype=np.float32)[nl]
        node_attr = None
        if self.use_node_attr and osp.exists(pre + "node_attributes.txt"):
            node_attr = np.loadtxt(pre + "node_attributes.txt",
                                   delimiter=",", dtype=np.float32)
            if node_attr.ndim == 1:
                node_attr = node_attr[:, None]
        if node_labels is not None and node_attr is not None:
            x_all = np.concatenate([node_attr, node_labels], axis=1)
        else:
            x_all = node_labels if node_labels is not None else node_attr

        edge_attr_all = None
        if osp.exists(pre + "edge_labels.txt"):
            el = np.loadtxt(pre + "edge_labels.txt", delimiter=",",
                            dtype=np.int64)
            _, el = np.unique(el, return_inverse=True)
            edge_attr_all = np.eye(el.max() + 1, dtype=np.float32)[el]

        num_graphs = int(graph_of.max()) + 1
        node_start = np.zeros(num_graphs + 1, dtype=np.int64)
        np.add.at(node_start, graph_of + 1, 1)
        node_start = np.cumsum(node_start)

        edge_graph = graph_of[edges[:, 0]]
        order = np.argsort(edge_graph, kind="stable")
        edges_sorted = edges[order]
        eattr_sorted = edge_attr_all[order] if edge_attr_all is not None \
            else None
        edge_graph = edge_graph[order]
        estart = np.searchsorted(edge_graph, np.arange(num_graphs + 1))

        out = []
        for g in range(num_graphs):
            lo, hi = node_start[g], node_start[g + 1]
            elo, ehi = estart[g], estart[g + 1]
            ei = (edges_sorted[elo:ehi] - lo).T
            x = x_all[lo:hi] if x_all is not None else \
                np.ones((hi - lo, 1), dtype=np.float32)
            ea = eattr_sorted[elo:ehi] if eattr_sorted is not None else None
            out.append(Data(x=x, edge_index=ei, edge_attr=ea,
                            y=np.int64(y[g])))
        return out
