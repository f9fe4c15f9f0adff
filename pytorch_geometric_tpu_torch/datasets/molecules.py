"""Molecular, relational and vision datasets: ``QM9``, ``Entities``
(MUTAG-RDF, AIFB) and ``MNISTSuperpixels``.

Counterpart of ``pytorch_geometric_tpu/datasets/molecules.py``
(reference: examples/qm9_nn_conv.py:52, examples/rgcn.py:11,
examples/mnist_graclus.py). No download is attempted and nothing is
written under ``root``. Each reads its raw release where it is under
``<root>/.../raw/`` (the readers of ``datasets/io.py``), and otherwise
builds the JAX package's synthetic corpus, draw for draw, flagged via
``dataset.is_synthetic``.

``Entities``: one relational graph per corpus, ``edge_index`` (2, E),
``edge_type`` (E,), labels ``y`` (N,) with -1 for unlabelled entities,
``train_idx`` / ``test_idx`` over the labelled ones. Resolution order:

1. ``<name>.tgz``, the RDF release: ``<name>_stripped.nt.gz`` (or
   ``.nt``) and the ``trainingSet.tsv`` / ``testSet.tsv`` splits; every
   subject and object an entity, every predicate a relation in both
   directions (``2 r`` and ``2 r + 1``);
2. ``<name>.npz``: the arrays above, as saved with ``np.savez`` (plain
   arrays only; nothing is unpickled);
3. the synthetic graph with the corpus's shapes: ``int(N * scale)``
   entities, six random typed edges per entity, labels from the parity
   of relation 0's in-degree, an 80/20 split of the labelled entities.
   ``scale=1.0`` gives MUTAG-RDF's published size (23,644 entities,
   141,864 edges, 46 relations, 2 classes).

``QM9``: the GDB-9 release ``dsgdb9nsd.xyz.tar.bz2`` (one ``.xyz``
record a molecule, bonds guessed from the interatomic distances), or
the synthetic corpus. The JAX package's ``qm9.npz`` holds pickled
records, which the port does not unpickle: it is refused with an error.

``MNISTSuperpixels``: PyG's raw ``training.pt`` / ``test.pt`` (a
torch-saved tuple ``(x, edge_index, edge_slice, pos, y)``, 75 nodes a
graph, loaded with ``weights_only=True``), or the synthetic corpus.
"""

import gzip
import os.path as osp

import numpy as np

from pytorch_geometric_tpu_torch.cluster import knn_graph
from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset
from pytorch_geometric_tpu_torch.datasets.io import (
    iter_tar_members,
    load_torch_tuple,
    parse_entities_rdf,
    qm9_distance_bonds,
    read_qm9_xyz,
)


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

    #: (entity column, label column) of each corpus's split files.
    TSV_COLS = {"mutag": ("bond", "label_mutagenic"),
                "aifb": ("person", "label_affiliation")}

    @property
    def raw_file_names(self):
        return [f"{self.name}.npz", f"{self.name}.tgz"]

    @property
    def num_relations(self):
        return self.SHAPES[self.name][1]

    @property
    def num_classes(self):
        return self.SHAPES[self.name][2]

    def process_full(self):
        n_full, R, C, n_lab = self.SHAPES[self.name]
        if osp.exists(self.raw_paths[1]):
            return [self._read_rdf(self.raw_paths[1])]
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

    def _read_rdf(self, path):
        nt = train_tsv = test_tsv = None
        for name, blob in iter_tar_members(path, ""):
            if name.endswith(".nt.gz"):
                nt = gzip.decompress(blob)
            elif name.endswith(".nt"):
                nt = blob
            elif "trainingSet" in name:
                train_tsv = blob
            elif "testSet" in name:
                test_tsv = blob
        parsed = parse_entities_rdf(nt, train_tsv, test_tsv,
                                    *self.TSV_COLS[self.name])
        n = parsed.pop("num_nodes")
        parsed.pop("num_relations")
        parsed.pop("num_classes")
        return Data(num_nodes_hint=np.zeros(n, dtype=np.int8), **parsed)


class QM9(InMemoryDataset):
    """~130k molecules; the synthetic corpus defaults to 8k molecules with
    the canonical per-molecule shapes (5 atom features, 4 bond types one
    hot, 3-d positions, 19 targets; 4-29 atoms, a chain plus random
    bonds in both directions)."""

    def __init__(self, root, transform=None, pre_transform=None,
                 pre_filter=None, num_synthetic: int = 8000):
        self.num_synthetic = num_synthetic
        self.is_synthetic = False
        super().__init__(osp.join(root, "qm9"), transform, pre_transform,
                         pre_filter)

    @property
    def raw_file_names(self):
        return ["qm9.npz", "dsgdb9nsd.xyz.tar.bz2"]

    def process_full(self):
        if osp.exists(self.raw_paths[1]):
            out = []
            for _, blob in iter_tar_members(self.raw_paths[1], ".xyz"):
                x, pos, y = read_qm9_xyz(blob)
                ei, ea = qm9_distance_bonds(pos)
                out.append(Data(x=x, edge_index=ei, edge_attr=ea, pos=pos,
                                y=y))
            return out
        if osp.exists(self.raw_paths[0]):
            raise NotImplementedError(
                f"QM9: the raw release {self.raw_paths[0]} holds pickled "
                "records, which the port does not load; use the .xyz "
                "release, or delete it for the synthetic corpus")
        self.is_synthetic = True
        rng = np.random.default_rng(17)
        out = []
        for _ in range(self.num_synthetic):
            n = int(rng.integers(4, 30))
            # chain + random extra bonds (molecule-like sparsity)
            s = np.arange(n - 1)
            r = s + 1
            extra = max(n // 4, 1)
            es = rng.integers(0, n, extra)
            er = rng.integers(0, n, extra)
            keep = es != er
            s = np.concatenate([s, es[keep]])
            r = np.concatenate([r, er[keep]])
            ei = np.stack([np.concatenate([s, r]), np.concatenate([r, s])])
            key = ei[0] * n + ei[1]
            _, first = np.unique(key, return_index=True)
            ei = ei[:, first]
            bond = rng.integers(0, 4, ei.shape[1])
            ea = np.eye(4, dtype=np.float32)[bond]
            x = rng.normal(size=(n, 5)).astype(np.float32)
            pos = rng.normal(size=(n, 3)).astype(np.float32)
            y = rng.normal(size=(1, 19)).astype(np.float32)
            # target 0 learnable: mean feature + size effect
            y[0, 0] = x.mean() + 0.05 * n
            out.append(Data(x=x, edge_index=ei, edge_attr=ea, pos=pos, y=y))
        return out


class MNISTSuperpixels(InMemoryDataset):
    """75-node superpixel MNIST graphs (reference ConvexPruning.py:515).
    The synthetic corpus: 75 random superpixels a graph, 8 nearest
    neighbours each, an intensity that encodes the digit class."""

    def __init__(self, root, train: bool = True, transform=None,
                 pre_transform=None, pre_filter=None,
                 num_synthetic: int = 6000):
        self.train = train
        self.num_synthetic = num_synthetic if train else num_synthetic // 6
        self.is_synthetic = False
        super().__init__(
            osp.join(root, "mnist_superpixels",
                     "train" if train else "test"),
            transform, pre_transform, pre_filter)

    @property
    def raw_file_names(self):
        return ["training.pt" if self.train else "test.pt"]

    def process_full(self):
        if osp.exists(self.raw_paths[0]):
            return self._read_pt(self.raw_paths[0])
        self.is_synthetic = True
        rng = np.random.default_rng(5 if self.train else 6)
        out = []
        centers = rng.random((10, 4, 2)).astype(np.float32)  # digit blobs
        for _ in range(self.num_synthetic):
            y = int(rng.integers(0, 10))
            pos = rng.random((75, 2)).astype(np.float32) * 25.0
            # intensity = proximity to the digit's blob centers
            d = np.linalg.norm(
                pos[:, None, :] / 25.0 - centers[y][None], axis=-1)
            x = np.exp(-8.0 * d.min(axis=1))[:, None].astype(np.float32)
            x += rng.normal(0, 0.05, size=x.shape).astype(np.float32)
            s, r = knn_graph(pos, k=8)
            out.append(Data(x=x, edge_index=np.stack([s, r]), pos=pos,
                            y=np.int64(y)))
        return out

    @staticmethod
    def _read_pt(path, n=75):
        x, edge_index, edge_slice, pos, y = load_torch_tuple(path)
        m = int(y.shape[0])
        x = x.reshape(m, n, -1).astype(np.float32)
        pos = pos.reshape(m, n, 2).astype(np.float32)
        out = []
        for i in range(m):
            lo, hi = int(edge_slice[i]), int(edge_slice[i + 1])
            ei = edge_index[:, lo:hi].astype(np.int64)
            if ei.size and ei.min() >= n * i:
                ei = ei - n * i     # the files' global node ids
            out.append(Data(x=x[i], edge_index=ei, pos=pos[i],
                            y=np.int64(y[i])))
        return out
