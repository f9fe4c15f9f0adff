"""Port parity: the mesh, point-cloud and large-graph corpora, the point
transforms and the graclus coarsening levels, against the JAX package.

- ``FAUST``, ``ModelNet``, ``Reddit`` (1/8 scale) and ``Amazon``: the
  synthetic branches draw for draw (each JAX dataset under its own
  ``tmp_path``); FAUST at 6890 vertices has the published template's
  size class (58 x 116 = 6,728 vertices).
- ``Center``, ``NormalizeScale``, ``FaceToEdge``, ``SamplePoints`` (with
  normals, three calls from one generator) and ``RandomTranslate``.
- ``PrecomputeGraclusCoarsening`` over the port's native graclus.

Every array is compared exactly: both packages run the same numpy and
the same native code.
"""

import numpy as np
import pytest

from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu import transforms as jtf
from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.transforms.coarsen_levels import (
    PrecomputeGraclusCoarsening as JCoarsen)
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch import transforms as ttf
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.datasets.meshes import _sphere_mesh
from pytorch_geometric_tpu_torch.transforms.coarsen_levels import (
    PrecomputeGraclusCoarsening)

KEYS = ("x", "edge_index", "edge_attr", "y", "pos", "face", "norm",
        "train_mask", "val_mask", "test_mask", "cluster1", "cluster2",
        "cluster3")


def _same_record(a, b):
    for key in KEYS:
        va, vb = getattr(a, key, None), getattr(b, key, None)
        assert (va is None) == (vb is None), key
        if va is not None:
            vb = np.asarray(vb)
            assert va.dtype == vb.dtype and va.shape == vb.shape, key
            np.testing.assert_array_equal(va, vb, err_msg=key)


def _same_records(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        _same_record(port[i], ref[i])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("num_vertices", [50, 684])
def test_faust_synthetic_matches_jax(num_vertices, train, tmp_path):
    port = tds.FAUST(str(tmp_path / "port"), train=train,
                     num_vertices=num_vertices)
    ref = jds.FAUST(str(tmp_path / "jax"), train=train,
                    num_vertices=num_vertices)
    assert port.is_synthetic and len(port) == (80 if train else 20)
    assert not (tmp_path / "port").exists()          # nothing written
    _same_records(port, ref)
    d = port[0]
    np.testing.assert_array_equal(d.y, np.arange(d.num_nodes))


def test_faust_at_the_published_vertex_count():
    ds = tds.FAUST("unused", train=False, num_vertices=6890,
                   pre_transform=ttf.Compose([ttf.FaceToEdge(),
                                              ttf.Cartesian()]))
    d = ds[3]
    assert d.num_nodes == 58 * 116 == 6728
    assert d.edge_index.shape == (2, 39904)
    assert d.edge_attr.shape == (39904, 3)
    assert 0.0 <= d.edge_attr.min() and d.edge_attr.max() <= 1.0


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ["10", "40"])
def test_modelnet_synthetic_matches_jax(name, train, tmp_path):
    port = tds.ModelNet(str(tmp_path / "port"), name, train=train,
                        samples_per_class=4)
    ref = jds.ModelNet(str(tmp_path / "jax"), name, train=train,
                       samples_per_class=4)
    assert port.is_synthetic
    assert len(port) == int(name) * (4 if train else 2)
    _same_records(port, ref)
    with pytest.raises(ValueError, match="'10' or '40'"):
        tds.ModelNet(str(tmp_path), "20")


def test_reddit_synthetic_matches_jax(tmp_path):
    port, ref = tds.Reddit(str(tmp_path / "port")), jds.Reddit(
        str(tmp_path / "jax"))
    assert port.is_synthetic
    d = port[0]
    assert d.num_nodes == 232965 // 8 and d.x.shape[1] == 602
    assert int(d.y.max()) == 40
    _same_records(port, ref)


@pytest.mark.parametrize("name", ["computers", "Photo"])
def test_amazon_synthetic_matches_jax(name, tmp_path):
    port = tds.Amazon(str(tmp_path / "port"), name)
    ref = jds.Amazon(str(tmp_path / "jax"), name)
    assert port.is_synthetic
    assert port[0].x.shape == tds.Amazon.SHAPES[name.lower()][:2]
    _same_records(port, ref)
    with pytest.raises(ValueError, match="unknown Amazon"):
        tds.Amazon(str(tmp_path), "books")


def _mesh_pair(seed=0, n_theta=6):
    pos, face = _sphere_mesh(n_theta, 2 * n_theta,
                             np.random.default_rng(seed), jitter=0.05)
    pos = pos * np.float32(3.0) + np.float32(0.5)
    kw = dict(pos=pos, face=face, x=np.ones((pos.shape[0], 2), np.float32))
    return Data(**kw), JData(**{k: v.copy() for k, v in kw.items()})


@pytest.mark.parametrize("name", ["Center", "NormalizeScale", "FaceToEdge",
                                  "FaceToEdge_keep", "SamplePoints",
                                  "SamplePoints_normals", "RandomTranslate"])
def test_point_transforms_match_jax(name):
    kw = {"FaceToEdge_keep": dict(remove_faces=False),
          "SamplePoints": dict(num=64, seed=3),
          "SamplePoints_normals": dict(num=100, include_normals=True,
                                       remove_faces=False, seed=4),
          "RandomTranslate": dict(translate=0.1, seed=5)}.get(name, {})
    cls = name.split("_")[0]
    port, ref = getattr(ttf, cls)(**kw), getattr(jtf, cls)(**kw)
    for seed in range(3):      # one generator across calls
        a, b = _mesh_pair(seed)
        _same_record(port(a), ref(b))
    if cls == "NormalizeScale":
        assert np.abs(a.pos).max() < 1.0
        np.testing.assert_allclose(a.pos.mean(0), 0.0, atol=1e-6)


@pytest.mark.parametrize("levels", [1, 3])
def test_graclus_levels_match_jax(levels):
    a, b = _mesh_pair(1, n_theta=8)
    a, b = ttf.FaceToEdge()(a), jtf.FaceToEdge()(b)
    port = PrecomputeGraclusCoarsening(levels, seed=2)(a)
    ref = JCoarsen(levels, seed=2)(b)
    _same_record(port, ref)
    assert repr(PrecomputeGraclusCoarsening(levels)) == \
        f"PrecomputeGraclusCoarsening(levels={levels})"
    # each level maps every node to a representative of the level before
    prev = np.arange(a.num_nodes)
    for k in range(1, levels + 1):
        rep = getattr(port, f"cluster{k}")
        assert set(rep.tolist()) <= set(prev.tolist())
        assert np.unique(rep).size < np.unique(prev).size
        prev = rep
