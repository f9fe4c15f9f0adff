"""Port parity, slice 16: the dataset base (``Dataset``, ``Subset``,
``InMemoryDataset`` with ``pre_filter``, ``DataView``) and the loaders
(``DataLoader``, ``DataListLoader``, ``DenseDataLoader``,
``DenseBatch``) against the JAX package on the same records.

The loaders must give the same batches in the same order from one seed
(both shuffle with ``np.random.default_rng(seed).shuffle``), padded to
the same budgets, so every collated field is compared exactly. The JAX
datasets are built under ``tmp_path``: a JAX dataset reads a
``processed/data.pkl`` where it finds one, and the port never does.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import DataListLoader as JDataListLoader
from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.data import DenseDataLoader as JDenseDataLoader
from pytorch_geometric_tpu.data.dataset import InMemoryDataset as JInMemory
from pytorch_geometric_tpu.transforms import ToDense as JToDense
from pytorch_geometric_tpu_torch.data import (
    Data, DataListLoader, DataLoader, DenseBatch, DenseDataLoader,
    InMemoryDataset, Subset)
from pytorch_geometric_tpu_torch.transforms import ToDense

FIELDS = ("x", "senders", "receivers", "node_mask", "edge_mask", "batch",
          "y", "graph_mask")


def _records(seed=0, count=13):
    """Graphs of 5-30 nodes with graph-level labels and edge attributes,
    as plain arrays (one dict per graph)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 30))
        e = int(rng.integers(n, 3 * n))
        out.append(dict(
            x=rng.normal(size=(n, 4)).astype(np.float32),
            edge_index=np.stack([rng.integers(0, n, e),
                                 rng.integers(0, n, e)]),
            edge_attr=rng.normal(size=(e, 2)).astype(np.float32),
            y=np.int64(rng.integers(0, 3))))
    return out


class _Port(InMemoryDataset):
    def __init__(self, records, root=None, **kw):
        self.records = records
        super().__init__(root, **kw)

    @property
    def raw_file_names(self):
        return []

    def process_full(self):
        return [Data(**r) for r in self.records]


class _Jax(JInMemory):
    def __init__(self, records, root, **kw):
        self.records = records
        super().__init__(str(root), **kw)

    @property
    def raw_file_names(self):
        return []

    def download(self):
        pass

    def process_full(self):
        return [JData(**r) for r in self.records]


def _pair(tmp_path, count=13, **kw):
    records = _records(count=count)
    return _Port(records, **kw), _Jax(records, tmp_path / "jax", **kw)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _same_batch(port, ref):
    assert (port.num_nodes, port.num_edges, port.num_graphs) == (
        ref.num_nodes, ref.num_edges, ref.num_graphs)
    for name in FIELDS:
        np.testing.assert_array_equal(_np(getattr(port, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(port.edge_attr),
                                  np.asarray(ref.edge_attr))


# ---------------------------------------------------------------------------
# the dataset base
# ---------------------------------------------------------------------------

def _ys(ds):
    return [ds[i].y.item() for i in range(len(ds))]


@pytest.mark.parametrize("index", [
    "slice", "mask", "array", "shuffle", "nested"])
def test_dataset_index_select_matches_jax(index, tmp_path):
    port, ref = _pair(tmp_path)
    mask = np.arange(len(port)) % 3 == 1
    pick = {"slice": lambda d: d[2:11:3], "mask": lambda d: d[mask],
            "array": lambda d: d[np.array([7, 0, 7, 12])],
            "shuffle": lambda d: d.shuffle(seed=4),
            "nested": lambda d: d.shuffle(seed=1)[1:9][np.array([5, 0])]}
    got, want = pick[index](port), pick[index](ref)
    assert isinstance(got, Subset)
    assert len(got) == len(want) and _ys(got) == _ys(want)
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i].x, want[i].x)
    np.testing.assert_array_equal(got.indices, want.indices)


def test_dataset_int_index_properties_and_transform(tmp_path):
    calls = []

    def transform(d):
        calls.append(1)
        d.x = d.x * 2
        return d

    port, ref = _pair(tmp_path, transform=transform)
    assert isinstance(port[np.int64(3)], Data)
    np.testing.assert_array_equal(port[3].x, ref[3].x)
    # the transform works on a clone: the stored record is untouched
    np.testing.assert_array_equal(port.get(3).x, _records()[3]["x"])
    assert (port.num_classes, port.num_features, port.num_edge_features) \
        == (ref.num_classes, ref.num_features, ref.num_edge_features) \
        == (3, 4, 2)
    sub = port[1:4]
    np.testing.assert_array_equal(sub[0].x, port[1].x)   # parent transform
    assert sub.num_classes == 3 and repr(port) == "_Port(13)"


def test_pre_filter_then_pre_transform_as_in_jax(tmp_path):
    def keep(d):
        return d.num_nodes % 2 == 0

    def pre(d):
        d.x = d.x + 1.0
        return d

    port, ref = _pair(tmp_path, pre_filter=keep, pre_transform=pre)
    assert 0 < len(port) == len(ref) < 13
    for i in range(len(port)):
        np.testing.assert_array_equal(port[i].x, ref[i].x)
        assert port[i].num_nodes % 2 == 0
    assert port.pre_filter is keep and port[0:2].pre_filter is keep


def test_data_view_reads_and_writes_through(tmp_path):
    port, ref = _pair(tmp_path)
    for key in ("x", "edge_index", "y"):
        np.testing.assert_array_equal(getattr(port.data, key),
                                      getattr(ref.data, key))
    y = port.data.y * 10 + 1
    port.data.y = y
    ref.data.y = y
    np.testing.assert_array_equal(port.data.y, y)
    assert _ys(port) == _ys(ref) == list(y)
    with pytest.raises(AttributeError):
        port.data.no_such_field


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size,dynamic", [(1, False), (4, False),
                                                (4, True)])
def test_data_loader_batches_match_jax(batch_size, dynamic, tmp_path):
    """Three shuffled epochs from seed 0: the same graphs in each batch,
    in the same order, collated to the same budgets and values."""
    port, ref = _pair(tmp_path)
    kw = dict(batch_size=batch_size, shuffle=True, seed=0,
              dynamic_buckets=dynamic)
    pl, jl = DataLoader(port, device="cpu", **kw), JDataLoader(ref, **kw)
    assert (len(pl), pl.num_nodes, pl.num_edges, pl.num_graphs) == (
        len(jl), jl.num_nodes, jl.num_edges, jl.num_graphs)
    shapes = set()
    for _ in range(3):
        got, want = list(pl.indexed()), list(jl)
        assert len(got) == len(want) == len(pl)
        for (idx, g), r in zip(got, want):
            _same_batch(g, r)
            np.testing.assert_array_equal(
                _np(g.y)[:len(idx)], [port[int(i)].y.item() for i in idx])
            shapes.add((g.num_nodes, g.num_edges))
    assert (len(shapes) > 1) == dynamic


def test_data_loader_without_shuffle_drop_last_and_budgets(tmp_path):
    port, ref = _pair(tmp_path)
    kw = dict(batch_size=5, drop_last=True, num_nodes=160, num_edges=384)
    pl, jl = DataLoader(port, device="cpu", **kw), JDataLoader(ref, **kw)
    got, want = list(pl), list(jl)
    assert len(got) == len(want) == len(pl) == 2
    for g, r in zip(got, want):
        _same_batch(g, r)
        assert (g.num_nodes, g.num_edges) == (160, 384)
    assert [i.tolist() for i, _ in pl.indexed()] == [list(range(5)),
                                                     list(range(5, 10))]
    assert got[0].device == torch.device("cpu")


@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, True)])
def test_data_list_loader_matches_jax(shuffle, drop_last, tmp_path):
    port, ref = _pair(tmp_path)
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=7)
    pl, jl = DataListLoader(port, **kw), JDataListLoader(ref, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        for got, want in zip(pl, jl, strict=True):
            assert [d.num_nodes for d in got] == [d.num_nodes for d in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.edge_index, b.edge_index)


def test_dense_data_loader_and_dense_batch_match_jax(tmp_path):
    port, ref = _pair(tmp_path, pre_transform=None)
    port.transform, ref.transform = ToDense(32), JToDense(32)
    kw = dict(batch_size=4, shuffle=True, seed=3)
    pl = DenseDataLoader(port, device="cpu", **kw)
    jl = JDenseDataLoader(ref, **kw)
    assert len(pl) == len(jl) == 4
    for got, want in zip(pl, jl, strict=True):
        assert isinstance(got, DenseBatch)
        assert sorted(got) == sorted(want) == ["adj", "mask", "x", "y"]
        assert got.num_graphs == want.num_graphs
        for key in got:
            a, b = got[key].numpy(), np.asarray(want[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert got.adj is got["adj"]
    with pytest.raises(AttributeError):
        got.no_such_field
    assert DenseBatch().num_graphs == 0


def test_loaders_default_to_cuda_and_raise_without_it(monkeypatch,
                                                      tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = _pair(tmp_path)
    for cls in (DataLoader, DenseDataLoader):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(port)
