"""Relational entity graphs: ``Entities`` (MUTAG-RDF, AIFB).

Counterpart of ``Entities`` in ``pytorch_geometric_tpu/datasets/
molecules.py`` (reference: examples/rgcn.py:11). One relational graph
per corpus: ``edge_index`` (2, E), ``edge_type`` (E,), labels ``y`` (N,)
with -1 for unlabelled entities, ``train_idx`` / ``test_idx`` over the
labelled ones. Resolution order:

1. ``<root>/entities/<name>/raw/<name>.npz``: the arrays above, as saved
   with ``np.savez`` (plain arrays only; nothing is unpickled);
2. otherwise the deterministic synthetic graph with the corpus's shapes,
   the JAX package's generator draw for draw, flagged via
   ``dataset.is_synthetic``: ``int(N * scale)`` entities, six random
   typed edges per entity, labels from the parity of relation 0's
   in-degree, an 80/20 split of the labelled entities. ``scale=1.0``
   gives MUTAG-RDF's published size (23,644 entities, 141,864 edges, 46
   relations, 2 classes).

The ``.tgz`` RDF release, ``QM9`` and ``MNISTSuperpixels`` of the JAX
module are not ported yet. No download is attempted and nothing is
written under ``root``.
"""

import os.path as osp

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset


class Entities(InMemoryDataset):
    """Relational entity graph ``name`` ("MUTAG" or "AIFB")."""

    #: (entities, relations, classes, labelled entities) per corpus.
    SHAPES = {"mutag": (23644, 46, 2, 340),
              "aifb": (8285, 45, 4, 176)}

    def __init__(self, root, name, transform=None, pre_transform=None,
                 scale: float = 0.125):
        self.name = name.lower()
        if self.name not in self.SHAPES:
            raise ValueError(f"unknown entity corpus {name!r}; expected one "
                             f"of {sorted(self.SHAPES)}")
        self.scale = scale
        self.is_synthetic = False
        super().__init__(osp.join(root, "entities", self.name), transform,
                         pre_transform)

    @property
    def raw_file_names(self):
        return [f"{self.name}.npz"]

    @property
    def num_relations(self):
        return self.SHAPES[self.name][1]

    @property
    def num_classes(self):
        return self.SHAPES[self.name][2]

    def process_full(self):
        n_full, R, C, n_lab = self.SHAPES[self.name]
        if osp.exists(self.raw_paths[0]):
            with np.load(self.raw_paths[0]) as fz:
                return [Data(**{k: fz[k] for k in fz.files})]
        self.is_synthetic = True
        n = max(int(n_full * self.scale), 64)
        rng = np.random.default_rng(23)
        e = n * 6
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        et = rng.integers(0, R, e)
        labelled = rng.permutation(n)[:min(n_lab, n // 2)]
        y = np.full(n, -1, dtype=np.int64)
        # label correlated with a hub relation's degree parity
        deg = np.bincount(r[et == 0], minlength=n)
        y[labelled] = (deg[labelled] % C)
        split = rng.random(len(labelled))
        train_idx = labelled[split < 0.8]
        test_idx = labelled[split >= 0.8]
        return [Data(edge_index=np.stack([s, r]), edge_type=et,
                     y=y, train_idx=train_idx, test_idx=test_idx,
                     num_nodes_hint=np.zeros(n, dtype=np.int8))]
