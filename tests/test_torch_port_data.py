"""Port parity, data layer: the PyTorch port's collation, synthetic
graphs, Planetoid parse, transforms, self loops, degree and segment ops
against the JAX package, on the same numpy inputs (exact or fp32 1e-6)."""

import os.path as osp
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import bucket_size as j_bucket_size
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.datasets.planetoid import Planetoid as JPlanetoid
from pytorch_geometric_tpu.datasets.synthetic import (
    synthetic_citation_graph as j_synthetic)
from pytorch_geometric_tpu.ops import segment as jseg
from pytorch_geometric_tpu.transforms import NormalizeFeatures as JNormalize
from pytorch_geometric_tpu.utils.degree import degree as j_degree
from pytorch_geometric_tpu.utils.loop import add_self_loops as j_loops
from pytorch_geometric_tpu_torch.data import Data, bucket_size, from_data
from pytorch_geometric_tpu_torch.datasets import (
    Planetoid, synthetic_citation_graph)
from pytorch_geometric_tpu_torch.ops import segment as tseg
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures
from pytorch_geometric_tpu_torch.utils import add_self_loops, degree


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _random_data(rng, n, e, f=5, c=3, cls=Data):
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    masks = {k: rng.random(n) < 0.3 for k in
             ("train_mask", "val_mask", "test_mask")}
    return cls(x=rng.normal(size=(n, f)), edge_index=ei,
               y=rng.integers(0, c, n), **masks)


@pytest.mark.parametrize("n,e,sort_edges", [(37, 120, True),
                                            (200, 900, True),
                                            (64, 300, False)])
def test_from_data_matches_jax(n, e, sort_edges):
    rng = np.random.default_rng(n)
    data = _random_data(rng, n, e)
    jdata = _random_data(np.random.default_rng(n), n, e, cls=JData)
    g = from_data(data, sort_edges=sort_edges, device="cpu")
    jg = j_from_data(jdata, sort_edges=sort_edges)
    assert g.num_nodes == jg.num_nodes == bucket_size(n + 1)
    assert g.num_edges == jg.num_edges == bucket_size(e)
    for name in ("senders", "receivers", "x", "y", "node_mask",
                 "edge_mask", "batch"):
        a, b = _np(getattr(g, name)), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(g.extras) == set(jg.extras)
    for k in g.extras:
        np.testing.assert_array_equal(_np(g.extras[k]),
                                      np.asarray(jg.extras[k]), err_msg=k)
    # padding edges point at the first padding node and are masked
    pad = ~_np(g.edge_mask)
    assert (_np(g.senders)[pad] == n).all()
    assert (_np(g.receivers)[pad] == n).all()
    assert g.num_graphs == jg.num_graphs and g.edges_sorted == sort_edges


def test_bucket_ladder_and_cora_budgets():
    for n in list(range(0, 300)) + [2709, 10556, 19718, 88648]:
        assert bucket_size(n) == j_bucket_size(n)
    assert bucket_size(2708 + 1) == 3072 and bucket_size(10556) == 12288


def test_graph_to_and_extras_namespace():
    data = _random_data(np.random.default_rng(3), 20, 50)
    g = from_data(data, device="cpu")
    assert g.train_mask.dtype == torch.bool
    with pytest.raises(AttributeError):
        g.no_such_field
    h = g.to("cpu")
    assert h.device.type == "cpu" and set(h.extras) == set(g.extras)
    assert g.real_edge_mask().sum() == 50
    assert g.replace(edge_mask=None).real_edge_mask().all()


@pytest.mark.parametrize("name", ["cora", "citeseer"])
def test_synthetic_citation_graph_matches_jax(name):
    a, b = synthetic_citation_graph(name), j_synthetic(name)
    for key in ("x", "edge_index", "y", "train_mask", "val_mask",
                "test_mask"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_planetoid_synthetic_fallback_writes_nothing(tmp_path):
    ds = Planetoid(str(tmp_path), "Cora", transform=NormalizeFeatures())
    assert ds.is_synthetic and len(ds) == 1 and ds.num_classes == 7
    assert list(tmp_path.iterdir()) == []
    want = JNormalize()(j_synthetic("cora"))
    np.testing.assert_allclose(ds[0].x, want.x, rtol=1e-6)
    # the access-time transform works on a clone
    assert ds.data_list[0].x.max() == 1.0


def _write_planetoid_raw(raw, name, rng):
    """A small graph in the public Planetoid file layout."""
    n_x, n_all, n_test, f, c = 6, 20, 8, 12, 3
    feats = sp.csr_matrix((rng.random((n_all + n_test, f)) < 0.3)
                          .astype(np.float32))
    onehot = np.eye(c)[rng.integers(0, c, n_all + n_test)]
    test_idx = rng.permutation(np.arange(n_all, n_all + n_test))
    graph = {i: list(rng.integers(0, n_all + n_test, 3))
             for i in range(n_all + n_test)}
    objs = {"x": feats[:n_x], "tx": feats[n_all:], "allx": feats[:n_all],
            "y": onehot[:n_x], "ty": onehot[n_all:], "ally": onehot[:n_all],
            "graph": graph}
    raw.mkdir(parents=True)
    for part, obj in objs.items():
        with open(raw / f"ind.{name}.{part}", "wb") as f_:
            pickle.dump(obj, f_)
    np.savetxt(raw / f"ind.{name}.test.index", test_idx, fmt="%d")


def test_planetoid_raw_parse_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    _write_planetoid_raw(tmp_path / "port" / "Cora" / "raw", "cora", rng)
    _write_planetoid_raw(tmp_path / "jax" / "Cora" / "raw", "cora",
                         np.random.default_rng(7))
    a = Planetoid(str(tmp_path / "port"), "Cora")[0]
    b = JPlanetoid(str(tmp_path / "jax"), "Cora")[0]
    assert not osp.exists(tmp_path / "port" / "Cora" / "processed")
    for key in ("x", "edge_index", "y", "train_mask", "val_mask",
                "test_mask"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_self_loops_and_degree_match_jax():
    rng = np.random.default_rng(1)
    n, e = 30, 90
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    got = add_self_loops(torch.from_numpy(s), torch.from_numpy(r), n,
                         torch.from_numpy(w), fill_value=2.0)
    want = j_loops(jnp.asarray(s), jnp.asarray(r), n, jnp.asarray(w),
                   fill_value=2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert got[0].shape == (e + n,)
    mask = rng.random(e) < 0.5
    np.testing.assert_allclose(
        _np(degree(torch.from_numpy(r), n, weights=torch.from_numpy(w),
                   mask=torch.from_numpy(mask))),
        np.asarray(j_degree(jnp.asarray(r), n, weights=jnp.asarray(w),
                            mask=jnp.asarray(mask))), rtol=1e-6)


@pytest.mark.parametrize("reduce,dtype", [
    ("sum", np.float32), ("mean", np.float32), ("max", np.float32),
    ("min", np.float32), ("sum", np.int32), ("max", np.int32),
    ("min", np.int32)])
def test_segment_reductions_match_jax(reduce, dtype):
    rng = np.random.default_rng(2)
    n_seg, e = 12, 40
    ids = rng.integers(0, n_seg - 3, e)          # last 3 segments empty
    data = (rng.normal(size=(e, 4)) * 10).astype(dtype)
    got = tseg.scatter(torch.from_numpy(data), torch.from_numpy(ids), n_seg,
                       reduce=reduce)
    want = jseg.scatter(jnp.asarray(data), jnp.asarray(ids), n_seg,
                        reduce=reduce)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(4)
    n_seg, e = 10, 50
    ids = rng.integers(0, n_seg - 2, e)
    logits = rng.normal(size=(e, 3)).astype(np.float32) * 5
    mask = rng.random(e) < 0.8
    mask[ids == 0] = False                       # a fully masked segment
    for m in (None, mask):
        got = tseg.segment_softmax(
            torch.from_numpy(logits), torch.from_numpy(ids), n_seg,
            mask=None if m is None else torch.from_numpy(m))
        want = jseg.segment_softmax(
            jnp.asarray(logits), jnp.asarray(ids), n_seg,
            mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
