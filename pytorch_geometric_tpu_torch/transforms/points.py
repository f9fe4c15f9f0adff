"""Point-cloud and mesh transforms on the host's numpy ``Data``.

Counterpart of ``pytorch_geometric_tpu/transforms/points.py`` (reference:
``FaceToEdge`` of examples/faust.py, ``NormalizeScale`` and
``SamplePoints`` of examples/pointnet++.py, ``Center``,
``RandomTranslate``). numpy only, with the JAX package's draws: a
transform that samples owns a ``np.random.default_rng(seed)`` and draws
from it in the same order.
"""

import numpy as np


class Center:
    def __call__(self, data):
        data.pos = data.pos - data.pos.mean(axis=0, keepdims=True)
        return data


class NormalizeScale:
    """Center, then scale into (-1, 1)."""

    def __call__(self, data):
        data = Center()(data)
        data.pos = data.pos * ((1.0 / np.abs(data.pos).max()) * 0.999999)
        return data


class FaceToEdge:
    """Triangle faces (3, M) -> the undirected ``edge_index``, each
    directed edge once, ordered by (sender, receiver)."""

    def __init__(self, remove_faces: bool = True):
        self.remove_faces = remove_faces

    def __call__(self, data):
        face = data.face
        ei = np.concatenate([face[:2], face[1:], face[::2]], axis=1)
        s = np.concatenate([ei[0], ei[1]])
        r = np.concatenate([ei[1], ei[0]])
        key = s.astype(np.int64) * data.num_nodes + r
        _, first = np.unique(key, return_index=True)
        data.edge_index = np.stack([s[first], r[first]])
        if self.remove_faces:
            data.face = None
        return data


class SamplePoints:
    """``num`` points drawn uniformly on the mesh's faces (a face by its
    area, then a point of it), with the faces' unit normals as ``norm``
    when ``include_normals``."""

    def __init__(self, num: int, remove_faces: bool = True,
                 include_normals: bool = False, seed: int = 0):
        self.num = num
        self.remove_faces = remove_faces
        self.include_normals = include_normals
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        pos, face = data.pos.astype(np.float64), data.face
        v0, v1, v2 = pos[face[0]], pos[face[1]], pos[face[2]]
        area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
        prob = area / max(area.sum(), 1e-12)
        choice = self.rng.choice(face.shape[1], size=self.num, p=prob)
        u = self.rng.random((self.num, 1))
        v = self.rng.random((self.num, 1))
        flip = (u + v > 1).reshape(-1)
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        e1, e2 = v1[choice] - v0[choice], v2[choice] - v0[choice]
        if self.include_normals:
            n = np.cross(e1, e2)
            data.norm = (n / np.maximum(
                np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            ).astype(np.float32)
        data.pos = (v0[choice] + u * e1 + v * e2).astype(np.float32)
        data.x = None
        if self.remove_faces:
            data.face = None
        return data


class RandomTranslate:
    """Each coordinate moved by a uniform draw from [-translate,
    translate)."""

    def __init__(self, translate: float, seed: int = 0):
        self.translate = translate
        self.rng = np.random.default_rng(seed)

    def __call__(self, data):
        jitter = self.rng.uniform(-self.translate, self.translate,
                                  size=data.pos.shape)
        data.pos = (data.pos + jitter).astype(np.float32)
        return data
