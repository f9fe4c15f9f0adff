"""Molecular, relational and vision datasets: ``QM9``, ``Entities``
(MUTAG-RDF, AIFB) and ``MNISTSuperpixels``.

Counterpart of ``pytorch_geometric_tpu/datasets/molecules.py``
(reference: examples/qm9_nn_conv.py:52, examples/rgcn.py:11,
examples/mnist_graclus.py). No download is attempted and nothing is
written under ``root``.

``Entities``: one relational graph per corpus, ``edge_index`` (2, E),
``edge_type`` (E,), labels ``y`` (N,) with -1 for unlabelled entities,
``train_idx`` / ``test_idx`` over the labelled ones. Resolution order:

1. ``<root>/entities/<name>/raw/<name>.npz``: the arrays above, as saved
   with ``np.savez`` (plain arrays only; nothing is unpickled);
2. otherwise the deterministic synthetic graph with the corpus's shapes,
   the JAX package's generator draw for draw, flagged via
   ``dataset.is_synthetic``: ``int(N * scale)`` entities, six random
   typed edges per entity, labels from the parity of relation 0's
   in-degree, an 80/20 split of the labelled entities. ``scale=1.0``
   gives MUTAG-RDF's published size (23,644 entities, 141,864 edges, 46
   relations, 2 classes).

``QM9`` and ``MNISTSuperpixels``: the JAX package's synthetic branches,
draw for draw. Their raw releases are refused with an error rather than
replaced by synthetic graphs: the readers of the ``.xyz`` archive and of
the torch-saved ``.pt`` files (``datasets/io.py``) and of the RDF
``.tgz`` of ``Entities`` come with ROADMAP Queue A 4b, and the JAX
package's ``qm9.npz`` holds pickled records, which the port does not
unpickle.
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


def _refuse_raw(dataset, paths):
    present = [p for p in paths if osp.exists(p)]
    if present:
        raise NotImplementedError(
            f"{type(dataset).__name__}: the port reads no raw release yet "
            f"({present}); delete it to use the synthetic corpus")


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
        _refuse_raw(self, self.raw_paths)
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


def _knn_graph(pos, k):
    """``(senders, receivers)`` of each point's ``k`` nearest other
    points, receivers ascending and each one's neighbours by distance:
    ``cluster.knn_graph(pos, k)`` of the JAX package, whose numpy path
    sorts the k + 1 nearest (the point itself first) the same way."""
    p = np.asarray(pos, dtype=np.float64)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    near = np.argsort(d2, axis=1, kind="stable")[:, :k + 1]
    rows = np.repeat(np.arange(p.shape[0]), k + 1)
    cols = near.reshape(-1)
    keep = rows != cols
    return cols[keep], rows[keep]


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
        _refuse_raw(self, self.raw_paths)
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
            s, r = _knn_graph(pos, k=8)
            out.append(Data(x=x, edge_index=np.stack([s, r]), pos=pos,
                            y=np.int64(y)))
        return out
