"""Mesh and point-cloud datasets: ``FAUST`` and ``ModelNet``.

Counterpart of ``pytorch_geometric_tpu/datasets/meshes.py`` (reference:
``FAUST`` of examples/faust.py, 100 registered human scans of 6890
vertices with vertex-correspondence targets; ``ModelNet`` '10' / '40' of
examples/pointnet++.py, CAD meshes). No download is attempted and
nothing is written under ``root``:

- ``FAUST``: ``<root>/faust/<train|test>/raw/MPI-FAUST.zip``, the 100
  PLY registrations, the first 80 for training and the last 20 for
  testing (PyG's split), target = vertex id; otherwise deformed UV-sphere
  meshes (80 / 20), the JAX package's draws: ``num_vertices`` (684 =
  6890 / 10 by default; 6890 gives the published size) sets a 2:1
  latitude-longitude grid of ``n_theta = int(sqrt(num_vertices / 2))``
  rings.
- ``ModelNet``: ``<root>/modelnet<name>/<train|test>/raw/ModelNet<name>
  .zip`` (``<class>/<split>/*.off``); otherwise one anisotropic scaling
  of a jittered sphere mesh per class.
"""

import os.path as osp

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.dataset import InMemoryDataset
from pytorch_geometric_tpu_torch.datasets.io import (
    iter_zip_members,
    read_off,
    read_ply,
)


def _sphere_mesh(n_theta, n_phi, rng, jitter=0.0):
    """A UV-sphere triangle mesh: ``(pos (n_theta * n_phi, 3) float32,
    face (3, 2 (n_theta - 1) n_phi) int64)``, its vertices moved by
    ``rng.normal(0, jitter)`` when ``jitter``."""
    thetas = np.linspace(0.15, np.pi - 0.15, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = [[np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]
             for t in thetas for p in phis]
    pos = np.asarray(verts, dtype=np.float32)
    if jitter:
        pos = pos + rng.normal(0, jitter, pos.shape).astype(np.float32)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    return pos, np.asarray(faces, dtype=np.int64).T


class FAUST(InMemoryDataset):
    """Per-vertex classification over the vertex ids of registered human
    meshes (examples/faust.py)."""

    def __init__(self, root, train: bool = True, transform=None,
                 pre_transform=None, pre_filter=None,
                 num_vertices: int = 684):
        self.train = train
        self.num_vertices = num_vertices
        self.is_synthetic = False
        super().__init__(osp.join(root, "faust",
                                  "train" if train else "test"),
                         transform, pre_transform, pre_filter)

    @property
    def raw_file_names(self):
        return ["MPI-FAUST.zip"]

    def process_full(self):
        if osp.exists(self.raw_paths[0]):
            plys = [blob for name, blob in
                    iter_zip_members(self.raw_paths[0], ".ply")
                    if "registrations" in name and "tr_reg_" in name]
            plys = plys[:80] if self.train else plys[80:100]
            out = []
            for blob in plys:
                pos, face = read_ply(blob)
                out.append(Data(pos=pos, face=face,
                                y=np.arange(pos.shape[0], dtype=np.int64)))
            return out
        self.is_synthetic = True
        rng = np.random.default_rng(3 if self.train else 4)
        n_theta = max(int(np.sqrt(self.num_vertices / 2)), 4)
        out = []
        for i in range(80 if self.train else 20):
            pos, face = _sphere_mesh(n_theta, 2 * n_theta, rng,
                                     jitter=0.02 * (i % 10))
            out.append(Data(pos=pos, face=face,
                            y=np.arange(pos.shape[0], dtype=np.int64)))
        return out


class ModelNet(InMemoryDataset):
    """ModelNet10 / 40 CAD meshes, one class label a mesh."""

    def __init__(self, root, name: str = "10", train: bool = True,
                 transform=None, pre_transform=None, pre_filter=None,
                 samples_per_class: int = 40):
        if name not in ("10", "40"):
            raise ValueError(f"ModelNet name must be '10' or '40', got "
                             f"{name!r}")
        self.name = name
        self.train = train
        self.samples_per_class = samples_per_class if train else \
            max(samples_per_class // 4, 2)
        self.is_synthetic = False
        super().__init__(osp.join(root, f"modelnet{name}",
                                  "train" if train else "test"),
                         transform, pre_transform, pre_filter)

    @property
    def raw_file_names(self):
        return [f"ModelNet{self.name}.zip"]

    def process_full(self):
        if osp.exists(self.raw_paths[0]):
            split = f"/{'train' if self.train else 'test'}/"
            members = [(m, b) for m, b in
                       iter_zip_members(self.raw_paths[0], ".off")
                       if split in m]
            classes = sorted({m.split("/")[-3] for m, _ in members})
            cls_idx = {c: i for i, c in enumerate(classes)}
            out = []
            for name, blob in members:
                pos, face = read_off(blob.decode("ascii", errors="ignore"))
                out.append(Data(pos=pos, face=face,
                                y=np.int64(cls_idx[name.split("/")[-3]])))
            return out
        self.is_synthetic = True
        c = int(self.name)
        rng = np.random.default_rng(13 if self.train else 14)
        out = []
        for y in range(c):
            scale = (0.3 + rng.random(3) * (1 + y / c)).astype(np.float32)
            for _ in range(self.samples_per_class):
                pos, face = _sphere_mesh(8, 16, rng, jitter=0.01)
                out.append(Data(pos=pos * scale, face=face, y=np.int64(y)))
        return out
