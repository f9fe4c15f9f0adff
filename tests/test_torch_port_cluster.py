"""Port parity: ``cluster/`` and its native library.

- Each function of the port (its own copy of ``graphcore.cpp``, built by
  ``cluster/_native.py``) against the JAX package's native library on
  the same numpy inputs: bitwise equal.
- Each plain numpy version against the JAX package's numpy fallback
  (``get_lib`` patched to None there): bitwise equal.
- ``voxel_grid``, ``radius``, ``knn``, ``knn_graph`` and
  ``coalesce_edges`` against their plain versions, bitwise, on points of
  an integer grid too (equal distances: ties go by index in both); edges
  to coalesce come at most twice (the library's sort is not stable).
- ``graclus_cluster``, ``fps`` and ``sample_neighbors`` (C++
  ``mt19937_64`` against numpy's generator) hold the invariants of
  ``tests/test_cluster.py``, native and plain.
- The library builds into ``_build/`` under a hash of compiler, flags and
  source; processes that build at once do not collide.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_geometric_tpu import cluster as JC
from pytorch_geometric_tpu_torch import cluster as C
from pytorch_geometric_tpu_torch.cluster import _native

REPO = Path(__file__).resolve().parents[1]


def _points(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((120, 3))
    y = rng.random((40, 3))
    bx = np.repeat([0, 1, 2], 40)
    by = np.repeat([0, 1, 2], [10, 20, 10])
    return x, y, bx, by


def _edges(seed=1, n=60, e=300):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    s2, r2 = np.concatenate([s, r]), np.concatenate([r, s])
    return s2, r2, rng.random(2 * e), n


def _csr(n=40, seed=2):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, rng.integers(0, n, int(indptr[-1]))


def _calls(x, y, bx, by):
    """``{case: (function name, args, kwargs)}`` of every entry point."""
    s, r, w, n = _edges()
    attr = np.random.default_rng(3).random((s.size, 2))
    # every third distinct edge twice: the library's sort is not stable,
    # so three copies or more would sum in an order of its own
    _, first = np.unique(r * n + s, return_index=True)
    dup = np.concatenate([first, first[::3]])
    indptr, indices = _csr()
    return {
        "graclus": ("graclus_cluster", (s, r, w), dict(num_nodes=n, seed=5)),
        "graclus_unweighted": ("graclus_cluster", (s, r), dict(num_nodes=n)),
        "voxel_grid": ("voxel_grid", (x, 0.2), {}),
        "voxel_grid_batch": ("voxel_grid", (x, [0.2, 0.3, 0.25]),
                             dict(batch=bx, start=0.0, end=1.0)),
        "fps": ("fps", (x,), dict(ratio=0.3, seed=7)),
        "fps_batch": ("fps", (x,), dict(batch=bx, ratio=0.5,
                                        random_start=False)),
        "radius": ("radius", (x, y, 0.3), dict(max_num_neighbors=6)),
        "radius_batch": ("radius", (x, y, 0.35),
                         dict(batch_x=bx, batch_y=by)),
        "knn": ("knn", (x, y, 5), {}),
        "knn_batch": ("knn", (x, y, 4), dict(batch_x=bx, batch_y=by)),
        "knn_graph": ("knn_graph", (x, 6), {}),
        "knn_graph_loop_batch": ("knn_graph", (x, 3),
                                 dict(batch=bx, loop=True)),
        "coalesce": ("coalesce_edges", (s[dup], r[dup], attr[dup]),
                     dict(num_nodes=n)),
        "coalesce_no_attr": ("coalesce_edges", (s[dup], r[dup]), {}),
        "sample_neighbors": ("sample_neighbors", (indptr, indices,
                                                  np.arange(0, 40, 3), 3),
                             dict(seed=11)),
    }


CASES = sorted(_calls(*_points()))
#: Cases whose plain version is bitwise the library's.
EXACT = ("voxel_grid", "radius", "knn", "coalesce")


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert (u is None) == (v is None)
        if u is not None:
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("case", CASES)
def test_native_is_bitwise_the_jax_library(case):
    name, args, kw = _calls(*_points())[case]
    assert JC._native.get_lib() is not None
    _same(getattr(C, name)(*args, **kw), getattr(JC, name)(*args, **kw))


@pytest.mark.parametrize("case", CASES)
def test_plain_is_bitwise_the_jax_numpy_fallback(case, monkeypatch):
    name, args, kw = _calls(*_points())[case]
    plain = getattr(C, name + "_plain")(*args, **kw)
    monkeypatch.setattr(JC, "get_lib", lambda: None)
    _same(plain, getattr(JC, name)(*args, **kw))


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("case", [c for c in CASES if c.startswith(EXACT)])
def test_native_is_bitwise_its_plain_version(case, grid):
    """On random points, and on points of an integer grid, where many
    distances are equal."""
    x, y, bx, by = _points()
    if grid:
        x, y = np.floor(x * 4), np.floor(y * 4)
    name, args, kw = _calls(x, y, bx, by)[case]
    _same(getattr(C, name)(*args, **kw),
          getattr(C, name + "_plain")(*args, **kw))


@pytest.mark.parametrize("plain", [False, True])
def test_graclus_is_a_matching_of_adjacent_nodes(plain):
    s, r, w, n = _edges()
    fn = C.graclus_cluster_plain if plain else C.graclus_cluster
    for seed in (0, 3):
        cl = fn(s, r, w, num_nodes=n, seed=seed)
        assert cl.shape == (n,) and cl.dtype == np.int64
        members = {}
        for i, c in enumerate(cl):
            members.setdefault(int(c), []).append(i)
        for c, ms in members.items():
            assert len(ms) <= 2 and c == min(ms)
            if len(ms) == 2:
                a, b = ms
                assert (((s == a) & (r == b)) | ((s == b) & (r == a))).any()


@pytest.mark.parametrize("plain", [False, True])
def test_fps_picks_distinct_points_per_segment(plain):
    x, _, bx, _ = _points()
    fn = C.fps_plain if plain else C.fps
    idx = fn(x, ratio=0.25, seed=2)
    assert len(idx) == 30 and len(set(idx.tolist())) == 30
    idx = fn(x, batch=bx, ratio=0.5, random_start=False)
    assert (bx[idx] == np.repeat([0, 1, 2], 20)).all()
    assert len(set(idx.tolist())) == 60
    # the first pick without a random start is the segment's first point,
    # the second the point farthest from it
    assert idx[0] == 0
    assert idx[1] == np.argmax(((x[:40] - x[0]) ** 2).sum(1))


@pytest.mark.parametrize("plain", [False, True])
def test_sample_neighbors_samples_in_neighbours(plain):
    indptr, indices = _csr()
    fn = C.sample_neighbors_plain if plain else C.sample_neighbors
    seeds = np.arange(40)
    src, dst = fn(indptr, indices, seeds, 3, seed=4)
    for v in seeds:
        got = src[dst == v]
        nbrs = indices[indptr[v]:indptr[v + 1]]
        assert len(got) == min(3, len(nbrs))
        assert np.isin(got, nbrs).all()


def test_radius_and_knn_are_the_nearest_points():
    x, y, _, _ = _points()
    row, col = C.radius(x, y, 0.3, max_num_neighbors=200)
    d = np.linalg.norm(x[col] - y[row], axis=1)
    assert (d <= 0.3).all()
    assert row.size == int((np.linalg.norm(x[None] - y[:, None], axis=-1)
                            <= 0.3).sum())
    row, col = C.knn(x, y, 5)
    for i in range(y.shape[0]):
        mine = np.linalg.norm(x[col[row == i]] - y[i], axis=1)
        truth = np.sort(np.linalg.norm(x - y[i], axis=1))[:5]
        np.testing.assert_array_equal(mine, truth)


def test_library_is_built_under_a_hash_in_the_build_dir():
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.parent.name == "_build"
    assert path.name.startswith("libgraphcore-") and path.suffix == ".so"
    _native.get_lib()
    assert path.exists() and _native.build() == 0.0
    # the source is the port's own copy, without the TPU tile packing
    src = _native.SOURCE.read_text()
    assert _native.SOURCE.is_relative_to(REPO / "pytorch_geometric_tpu_torch")
    assert "int64_t pack_edges" not in src and "int64_t fps(" in src


_BUILD_ONE = """
import sys
from pathlib import Path
import numpy as np
from pytorch_geometric_tpu_torch.cluster import _native, fps
_native.BUILD_DIR = Path(sys.argv[1])
_native.build()
print(fps(np.random.default_rng(0).random((50, 3)), ratio=0.2).tolist())
"""


def test_parallel_builds_do_not_collide(tmp_path):
    """Four processes build into one empty directory at once: each loads
    a whole library, one library is left and no temporary file."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({out for out, _ in outs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        _native.library_path().name]
