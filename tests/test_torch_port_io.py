"""Port parity: the raw readers of ``datasets/io.py`` and the datasets'
raw branches, on the tiny archives that ``tests/test_dataset_io.py`` and
``tests/test_real_formats.py`` write, handed to both packages.

- ``read_off``, ``read_ply`` (ascii and binary), ``read_qm9_xyz``,
  ``qm9_distance_bonds``, ``parse_ntriples``, ``parse_entities_rdf``,
  ``iter_zip_members`` / ``iter_tar_members`` (macOS resource forks
  skipped) and ``load_torch_tuple``: equal to the JAX package's.
- The raw branches: ModelNet's and FAUST's zips, QM9's ``.xyz`` tarball,
  the ``.tgz`` RDF release of ``Entities``, MNISTSuperpixels' ``.pt``,
  Reddit's and Amazon's ``.npz``: every record equal to the JAX
  package's from the same file. The port writes nothing under ``root``.

Every array is compared exactly: both packages run the same numpy.
"""

import gzip
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import test_dataset_io as io_fixtures
import test_real_formats as format_fixtures
from pytorch_geometric_tpu import datasets as jds
from pytorch_geometric_tpu.datasets import io as jio
from pytorch_geometric_tpu_torch import datasets as tds
from pytorch_geometric_tpu_torch.datasets import io as tio

KEYS = ("x", "edge_index", "edge_attr", "edge_type", "y", "pos", "face",
        "train_idx", "test_idx", "train_mask", "val_mask", "test_mask",
        "num_nodes_hint")


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_records(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        a, b = port[i], ref[i]
        for key in KEYS:
            va, vb = getattr(a, key, None), getattr(b, key, None)
            assert (va is None) == (vb is None), key
            if va is not None:
                _same(np.asarray(va), np.asarray(vb))


def _files(root):
    return sorted(str(p) for p in root.rglob("*"))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_mesh_readers_match_jax():
    pos, face = io_fixtures._tet()
    off = io_fixtures._off_bytes(pos, face)
    glued = off.replace(b"OFF\n", b"OFF", 1)      # "OFF4 4 0"
    quad = b"OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n"
    for blob in (off, glued, quad):
        _same(tio.read_off(blob.decode()), jio.read_off(blob.decode()))
        _same(tio.read_off(blob), jio.read_off(blob))
    for blob in (io_fixtures._ply_ascii_bytes(pos, face),
                 io_fixtures._ply_binary_bytes(pos, face)):
        got = tio.read_ply(blob)
        _same(got, jio.read_ply(blob))
        np.testing.assert_allclose(got[0], pos, atol=1e-4)
        np.testing.assert_array_equal(got[1], face.T)
    with pytest.raises(ValueError, match="unsupported PLY"):
        tio.read_ply(b"ply\nformat binary_big_endian 1.0\nend_header\n")


def test_qm9_and_rdf_readers_match_jax():
    rec = format_fixtures._xyz_record(
        1, ["C", "H", "H", "H", "H"],
        [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0)],
        list(np.arange(15, dtype=float) + 1.0))
    x, pos, y = tio.read_qm9_xyz(rec)
    _same((x, pos, y), jio.read_qm9_xyz(rec))
    _same(tio.read_qm9_xyz(rec.encode()), jio.read_qm9_xyz(rec.encode()))
    _same(tio.qm9_distance_bonds(pos), jio.qm9_distance_bonds(pos))
    _same(tio.qm9_distance_bonds(pos[:1]), jio.qm9_distance_bonds(pos[:1]))
    nt = format_fixtures._NT
    assert list(tio.parse_ntriples(nt)) == list(jio.parse_ntriples(nt))
    args = (nt, format_fixtures._TRAIN_TSV, format_fixtures._TEST_TSV,
            "bond", "label_mutagenic")
    _same(tio.parse_entities_rdf(*args), jio.parse_entities_rdf(*args))


def test_archive_members_skip_resource_forks(tmp_path):
    members = {"a/x.off": b"1", "a/._x.off": b"junk",
               "__MACOSX/a/x.off": b"junk", "a/y.txt": b"2",
               "b/z.off": b"3"}
    zpath = tmp_path / "m.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for name, blob in members.items():
            zf.writestr(name, blob)
    tpath = tmp_path / "m.tar.gz"
    with tarfile.open(tpath, "w:gz") as tf:
        for name, blob in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    got = list(tio.iter_zip_members(zpath, ".off"))
    assert got == list(jio.iter_zip_members(zpath, ".off")) == [
        ("a/x.off", b"1"), ("b/z.off", b"3")]
    got = list(tio.iter_tar_members(tpath, ".off"))
    assert got == list(jio.iter_tar_members(tpath, ".off"))
    assert sorted(got) == [("a/x.off", b"1"), ("b/z.off", b"3")]


def test_load_torch_tuple_reads_tensors_only(tmp_path):
    path = tmp_path / "t.pt"
    obj = (torch.arange(6).reshape(2, 3), [torch.ones(2), 3], torch.zeros(0))
    torch.save(obj, path)
    _same(tio.load_torch_tuple(path), jio.load_torch_tuple(path))


# ---------------------------------------------------------------------------
# the datasets' raw branches
# ---------------------------------------------------------------------------

def _mesh_zip(path, kind):
    pos, face = io_fixtures._tet()
    with zipfile.ZipFile(path, "w") as zf:
        if kind == "modelnet":
            for cls in ("bed", "chair", "desk"):
                for split in ("train", "test"):
                    for i in range(2):
                        zf.writestr(f"ModelNet10/{cls}/{split}/{cls}_{i}.off",
                                    io_fixtures._off_bytes(pos * (1 + i),
                                                           face))
            zf.writestr("__MACOSX/ModelNet10/bed/train/._bed_0.off", b"x")
        else:
            for i in range(100):
                zf.writestr(
                    f"MPI-FAUST/training/registrations/tr_reg_{i:03d}.ply",
                    io_fixtures._ply_binary_bytes(pos + 0.01 * i, face))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["modelnet", "faust"])
def test_mesh_zips_match_jax(kind, train, tmp_path):
    split = "train" if train else "test"
    sub = f"modelnet10/{split}" if kind == "modelnet" else f"faust/{split}"
    raw = tmp_path / sub / "raw"
    os.makedirs(raw)
    _mesh_zip(raw / ("ModelNet10.zip" if kind == "modelnet"
                     else "MPI-FAUST.zip"), kind)
    before = _files(tmp_path)
    if kind == "modelnet":
        port = tds.ModelNet(str(tmp_path), "10", train=train)
        assert _files(tmp_path) == before
        ref = jds.ModelNet(str(tmp_path), "10", train=train)
        assert len(port) == 6
    else:
        port = tds.FAUST(str(tmp_path), train=train)
        assert _files(tmp_path) == before
        ref = jds.FAUST(str(tmp_path), train=train)
        assert len(port) == (80 if train else 20)
    assert not port.is_synthetic and not ref.is_synthetic
    _same_records(port, ref)


def test_qm9_xyz_tarball_matches_jax(tmp_path):
    raw = tmp_path / "qm9" / "raw"
    os.makedirs(raw)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:bz2") as tf:
        for i in range(4):
            rec = format_fixtures._xyz_record(
                i, ["C", "O", "H", "N"][:2 + i % 3],
                [(0, 0, 0), (1.2, 0, 0), (-0.9, 0.4, 0),
                 (0.3, 1.1, 0.2)][:2 + i % 3],
                list(np.linspace(0.1, 1.5, 15) * (i + 1))).encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{i:06d}.xyz")
            info.size = len(rec)
            tf.addfile(info, io.BytesIO(rec))
    (raw / "dsgdb9nsd.xyz.tar.bz2").write_bytes(buf.getvalue())
    before = _files(tmp_path)
    port = tds.QM9(str(tmp_path))
    assert _files(tmp_path) == before
    ref = jds.QM9(str(tmp_path))
    assert not port.is_synthetic and len(port) == 4
    _same_records(port, ref)


def test_entities_rdf_release_matches_jax(tmp_path):
    raw = tmp_path / "entities" / "mutag" / "raw"
    os.makedirs(raw)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, blob in (
                ("mutag_stripped.nt.gz", gzip.compress(format_fixtures._NT)),
                ("trainingSet.tsv", format_fixtures._TRAIN_TSV),
                ("testSet.tsv", format_fixtures._TEST_TSV)):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    (raw / "mutag.tgz").write_bytes(buf.getvalue())
    port = tds.Entities(str(tmp_path), "mutag")
    ref = jds.Entities(str(tmp_path), "mutag")
    assert not port.is_synthetic
    _same_records(port, ref)
    assert port[0].edge_index.shape == (2, 8)
    assert port[0].num_nodes == 5


def test_mnist_superpixels_pt_matches_jax(tmp_path):
    m, n = 3, 75
    gen = torch.Generator().manual_seed(0)
    x, pos = torch.rand(m * n, 1, generator=gen), torch.rand(m * n, 2,
                                                             generator=gen)
    eis, slices = [], [0]
    for i in range(m):
        e = 4 * n
        eis.append(torch.randint(0, n, (2, e), generator=gen) + i * n)
        slices.append(slices[-1] + e)
    raw = tmp_path / "mnist_superpixels" / "train" / "raw"
    os.makedirs(raw)
    torch.save((x, torch.cat(eis, dim=1), torch.tensor(slices), pos,
                torch.tensor([1, 7, 3])), raw / "training.pt")
    port = tds.MNISTSuperpixels(str(tmp_path), train=True)
    ref = jds.MNISTSuperpixels(str(tmp_path), train=True)
    assert not port.is_synthetic and len(port) == 3
    _same_records(port, ref)
    assert int(port[2].edge_index.max()) < n


def test_reddit_and_amazon_npz_match_jax(tmp_path):
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    raw = tmp_path / "reddit" / "raw"
    os.makedirs(raw)
    n = 30
    np.savez(raw / "reddit_data.npz",
             feature=rng.normal(size=(n, 602)).astype(np.float32),
             label=rng.integers(0, 41, n), node_types=rng.integers(1, 4, n))
    sp.save_npz(raw / "reddit_graph.npz",
                sp.random(n, n, density=0.2, format="csr", random_state=0))
    port, ref = tds.Reddit(str(tmp_path)), jds.Reddit(str(tmp_path))
    assert not port.is_synthetic
    _same_records(port, ref)

    n = 25
    fields = {**format_fixtures._sparse_npz_fields(
        "adj", sp.random(n, n, density=0.2, random_state=1)),
        **format_fixtures._sparse_npz_fields(
            "attr", sp.random(n, 40, density=0.3, random_state=2)),
        "labels": rng.integers(0, 5, n)}
    raw = tmp_path / "amazon" / "photo" / "raw"
    os.makedirs(raw)
    np.savez(raw / "amazon_electronics_photo.npz", **fields)
    port = tds.Amazon(str(tmp_path), "Photo")
    ref = jds.Amazon(str(tmp_path), "Photo")
    assert not port.is_synthetic and port[0].x.shape == (n, 40)
    _same_records(port, ref)
