"""Port parity, slice 16: the graph-classification and inductive corpora
against the JAX package, built under ``tmp_path`` from the same files.

- ``_synthetic_ppi`` and ``synthetic_graph_classification`` draw for
  draw, and the synthetic branches of ``PPI``, ``TUDataset``, ``QM9``,
  ``MNISTSuperpixels`` and ``CoraFull`` (CoraFull at a reduced shape
  table in both packages: its published 19,793 x 8,710 features are
  ~0.7 GB a copy);
- the file branches on files the tests write: PPI's GraphSAGE release,
  TU's text format, CoraFull's ``.npz``.

Every array is compared exactly: both packages run the same numpy.
"""

import json

import numpy as np
import pytest

from pytorch_geometric_tpu.datasets import synthetic as jsynthetic
from pytorch_geometric_tpu.datasets.molecules import QM9 as JQM9
from pytorch_geometric_tpu.datasets.molecules import (
    MNISTSuperpixels as JMNIST)
from pytorch_geometric_tpu.datasets.planetoid import CoraFull as JCoraFull
from pytorch_geometric_tpu.datasets.ppi import PPI as JPPI
from pytorch_geometric_tpu.datasets.ppi import _synthetic_ppi as j_synth_ppi
from pytorch_geometric_tpu.datasets.tu_dataset import TUDataset as JTU
from pytorch_geometric_tpu_torch.datasets import (
    PPI, QM9, CoraFull, MNISTSuperpixels, TUDataset, synthetic)
from pytorch_geometric_tpu_torch.datasets.ppi import _synthetic_ppi
from pytorch_geometric_tpu_torch.datasets.tu_dataset import _CANONICAL

KEYS = ("x", "edge_index", "edge_attr", "y", "pos")


def _same_records(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for key in KEYS:
            va, vb = getattr(a, key, None), getattr(b, key, None)
            assert (va is None) == (vb is None), key
            if va is not None:
                assert va.dtype == np.asarray(vb).dtype, key
                np.testing.assert_array_equal(va, vb, err_msg=key)


def _all(ds):
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_synthetic_ppi_is_the_jax_generator(split):
    port, ref = _synthetic_ppi(split), j_synth_ppi(split)
    _same_records(port, ref)
    assert len(port) == {"train": 20, "val": 2, "test": 2}[split]
    d = port[0]
    assert d.x.shape[1] == 50 and d.y.shape[1] == 121
    # random pairs in both directions: some repeat, none is a self loop
    key = d.edge_index[0] * d.num_nodes + d.edge_index[1]
    assert np.unique(key).size < key.size
    assert (d.edge_index[0] != d.edge_index[1]).all()


@pytest.mark.parametrize("args", [
    (30, 12, 3, 4, 0, 2.0, 5), (25, 9, 6, 2, 42, 1.5, None)])
def test_synthetic_graph_classification_is_the_jax_generator(args):
    g, n, f, c, seed, ef, labels = args
    kw = dict(seed=seed, edge_factor=ef, num_node_labels=labels)
    _same_records(synthetic.synthetic_graph_classification(g, n, f, c, **kw),
                  jsynthetic.synthetic_graph_classification(g, n, f, c,
                                                            **kw))


def test_ppi_synthetic_branch_matches_jax(tmp_path):
    port = PPI(str(tmp_path / "port"), "val")
    ref = JPPI(str(tmp_path / "jax"), "val")
    assert port.is_synthetic and ref.is_synthetic
    _same_records(_all(port), _all(ref))
    assert port.num_classes == 121 and port.num_features == 50
    assert not (tmp_path / "port").exists()      # the port writes nothing
    with pytest.raises(ValueError, match="split"):
        PPI(str(tmp_path), "dev")


def _write_ppi_release(raw, split):
    """A tiny GraphSAGE-format release: 3 graphs of 4-6 nodes, links
    within them (one repeated, one reversed), and a link across graphs
    that the reader drops."""
    rng = np.random.default_rng(5)
    sizes = [5, 4, 6]
    graph_id = np.repeat(np.arange(3) + 7, sizes)
    n = graph_id.size
    links = [(0, 1), (1, 2), (1, 0), (3, 4), (4, 0), (0, 1), (5, 6),
             (6, 7), (9, 10), (11, 14), (2, 2)]
    raw.mkdir(parents=True)
    s = {"val": "valid"}.get(split, split)
    (raw / f"{s}_graph.json").write_text(json.dumps(
        {"links": [{"source": a, "target": b} for a, b in links]}))
    np.save(raw / f"{s}_feats.npy", rng.normal(size=(n, 50)))
    np.save(raw / f"{s}_labels.npy",
            (rng.random((n, 121)) < 0.3).astype(np.int64))
    np.save(raw / f"{s}_graph_id.npy", graph_id)


@pytest.mark.parametrize("split", ["train", "val"])
def test_ppi_graphsage_release_matches_jax(split, tmp_path):
    for side in ("port", "jax"):
        _write_ppi_release(tmp_path / side / "ppi" / split / "raw", split)
    port = PPI(str(tmp_path / "port"), split)
    ref = JPPI(str(tmp_path / "jax"), split)
    assert not port.is_synthetic
    _same_records(_all(port), _all(ref))
    assert [d.num_nodes for d in _all(port)] == [5, 4, 6]
    assert port[0].x.dtype == np.float32 and port[0].y.dtype == np.float32


def _write_tu(raw, name, node_labels=True, node_attr=True,
              edge_labels=True):
    """A tiny TU corpus of 3 graphs (1-based ids, labels -1 / 1 / 5)."""
    raw.mkdir(parents=True)
    rng = np.random.default_rng(3)
    sizes = [4, 3, 5]
    ind = np.repeat(np.arange(1, 4), sizes)
    edges, start = [], 1
    for n in sizes:
        for _ in range(2 * n):
            a, b = rng.integers(0, n, 2) + start
            edges.append((a, b))
        start += n
    np.savetxt(raw / f"{name}_A.txt", np.array(edges), fmt="%d",
               delimiter=", ")
    np.savetxt(raw / f"{name}_graph_indicator.txt", ind, fmt="%d")
    np.savetxt(raw / f"{name}_graph_labels.txt", [-1, 1, 5], fmt="%d")
    if node_labels:
        np.savetxt(raw / f"{name}_node_labels.txt",
                   rng.integers(2, 6, ind.size), fmt="%d")
    if node_attr:
        np.savetxt(raw / f"{name}_node_attributes.txt",
                   rng.normal(size=(ind.size, 2)), fmt="%.6f",
                   delimiter=", ")
    if edge_labels:
        np.savetxt(raw / f"{name}_edge_labels.txt",
                   rng.integers(0, 3, len(edges)), fmt="%d")


@pytest.mark.parametrize("files,use_node_attr", [
    ((True, True, True), True), ((True, True, True), False),
    ((False, True, False), True), ((False, False, False), False)])
def test_tu_text_format_matches_jax(files, use_node_attr, tmp_path):
    for side in ("port", "jax"):
        _write_tu(tmp_path / side / "TOY" / "raw", "TOY", *files)
    port = TUDataset(str(tmp_path / "port"), "TOY",
                     use_node_attr=use_node_attr)
    ref = JTU(str(tmp_path / "jax"), "TOY", use_node_attr=use_node_attr)
    assert not port.is_synthetic
    _same_records(_all(port), _all(ref))
    assert [d.y.item() for d in _all(port)] == [0, 1, 2]


@pytest.mark.parametrize("name", ["MUTAG", "IMDB-BINARY", "OTHER"])
def test_tu_synthetic_branch_matches_jax(name, tmp_path, monkeypatch):
    """MUTAG's canonical statistics; a corpus without node labels; an
    unknown name's default. The larger canonical corpora are cut to 40
    graphs in both packages' tables (their generator is the one tested
    above)."""
    from pytorch_geometric_tpu.datasets import tu_dataset as jtu
    from pytorch_geometric_tpu_torch.datasets import tu_dataset as ttu

    if name == "IMDB-BINARY":
        for table in (jtu._CANONICAL, ttu._CANONICAL):
            monkeypatch.setitem(table, name, (40, 20, 0, 2))
    port = TUDataset(str(tmp_path / "port"), name)
    ref = JTU(str(tmp_path / "jax"), name)
    assert port.is_synthetic
    _same_records(_all(port), _all(ref))
    want = {"MUTAG": 188, "IMDB-BINARY": 40, "OTHER": 200}[name]
    assert len(port) == want and port.num_classes == ref.num_classes
    assert _CANONICAL["MUTAG"] == (188, 18, 7, 2)


def test_tu_pre_filter_and_slicing_as_examples_use_them(tmp_path):
    """examples/enzymes_diff_pool.py filters by size; examples/
    mutag_gin.py shuffles and slices."""
    kw = dict(pre_filter=lambda d: d.num_nodes <= 20)
    port = TUDataset(str(tmp_path / "port"), "MUTAG", **kw)
    ref = JTU(str(tmp_path / "jax"), "MUTAG", **kw)
    assert 0 < len(port) == len(ref) < 188
    _same_records(_all(port.shuffle(seed=2)[:30]),
                  _all(ref.shuffle(seed=2)[:30]))


def test_qm9_synthetic_branch_matches_jax(tmp_path):
    port = QM9(str(tmp_path / "port"), num_synthetic=40)
    ref = JQM9(str(tmp_path / "jax"), num_synthetic=40)
    assert port.is_synthetic
    _same_records(_all(port), _all(ref))
    d = port[0]
    assert d.edge_attr.shape[1] == 4 and d.y.shape == (1, 19)
    np.testing.assert_array_equal(port.data.y, ref.data.y)


@pytest.mark.parametrize("train", [True, False])
def test_mnist_superpixels_synthetic_branch_matches_jax(train, tmp_path):
    port = MNISTSuperpixels(str(tmp_path / "port"), train,
                            num_synthetic=24)
    ref = JMNIST(str(tmp_path / "jax"), train, num_synthetic=24)
    assert port.is_synthetic and len(port) == (24 if train else 4)
    _same_records(_all(port), _all(ref))
    assert port[0].num_nodes == 75 and port[0].num_edges == 75 * 8


@pytest.mark.parametrize("cls,name", [(QM9, "qm9.npz"),
                                      (MNISTSuperpixels, "training.pt")])
def test_raw_releases_that_the_port_cannot_read_are_refused(cls, name,
                                                            tmp_path):
    """QM9's ``qm9.npz`` holds pickled records; a ``.pt`` file that holds
    anything but tensors is refused by ``torch.load(weights_only=True)``
    (PyG's tuples of tensors load)."""
    import fractions
    import pickle

    import torch

    sub = "qm9" if cls is QM9 else "mnist_superpixels/train"
    raw = tmp_path / sub / "raw"
    raw.mkdir(parents=True)
    if cls is QM9:
        (raw / name).write_bytes(b"")
        with pytest.raises(NotImplementedError, match="raw release"):
            cls(str(tmp_path))
        return
    torch.save((torch.zeros(75, 1), fractions.Fraction(1, 3)), raw / name)
    with pytest.raises(pickle.UnpicklingError):
        cls(str(tmp_path))


def test_corafull_synthetic_branch_matches_jax(tmp_path, monkeypatch):
    from pytorch_geometric_tpu.datasets import synthetic as jsyn
    from pytorch_geometric_tpu_torch.datasets import synthetic as tsyn

    for table in (jsyn.CITATION_SHAPES, tsyn.CITATION_SHAPES):
        monkeypatch.setitem(table, "corafull", (300, 600, 120, 70))
    port = CoraFull(str(tmp_path / "port"))
    ref = JCoraFull(str(tmp_path / "jax"))
    assert port.is_synthetic
    _same_records(_all(port), _all(ref))
    for key in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(port[0], key),
                                      getattr(ref[0], key))


def test_corafull_npz_matches_jax(tmp_path):
    import scipy.sparse as sp

    rng = np.random.default_rng(9)
    n, f = 40, 30
    adj = sp.random(n, n, density=0.1, format="csr", random_state=1)
    attr = sp.random(n, f, density=0.2, format="csr", random_state=2)
    arrays = dict(adj_data=adj.data, adj_indices=adj.indices,
                  adj_indptr=adj.indptr, adj_shape=adj.shape,
                  attr_data=attr.data, attr_indices=attr.indices,
                  attr_indptr=attr.indptr, attr_shape=attr.shape,
                  labels=rng.integers(0, 5, n))
    for side in ("port", "jax"):
        raw = tmp_path / side / "corafull" / "raw"
        raw.mkdir(parents=True)
        np.savez(raw / "cora_full.npz", **arrays)
    port = CoraFull(str(tmp_path / "port"))
    ref = JCoraFull(str(tmp_path / "jax"))
    assert not port.is_synthetic
    _same_records(_all(port), _all(ref))
    assert port[0].x.shape == (n, f) and port.num_classes == ref.num_classes
