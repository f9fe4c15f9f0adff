"""Clustering and sampling on the host: the torch-cluster replacement.

Counterpart of ``pytorch_geometric_tpu/cluster/__init__.py`` (reference:
the torch-cluster 1.5.5 wheel; ``graclus_cluster`` via nn.graclus,
``voxel_grid``, ``fps`` and ``radius`` for PointNet++, kNN). These are
data-dependent and sequential (greedy matching) or loader-time
(sampling), so they stay host operations, as in the JAX package: they
take and return numpy arrays and run the native library
(``native/graphcore.cpp``, built by ``cluster/_native.py``), which
raises if it cannot be built.

Each function has a plain numpy version beside it (``fps_plain``, ...):
the JAX package's numpy fallbacks, kept as references for the tests and
never taken by the public functions. ``voxel_grid``, ``radius``,
``knn`` (so ``knn_graph``) and ``coalesce_edges`` are bitwise equal to
their plain versions (``knn_plain`` breaks distance ties by index, as
the library's sort does; ``coalesce_edges_plain`` sums attributes in
float64, as the library does). ``graclus_cluster``, ``fps`` and
``sample_neighbors`` draw from C++'s ``mt19937_64`` and their plain
versions from numpy's generator, so those agree in their invariants
only.
"""

import numpy as np

from pytorch_geometric_tpu_torch.cluster._native import (
    as_f64,
    as_i64,
    get_lib,
    ptr_f64,
    ptr_i64,
)


def _np(a):
    return None if a is None else np.asarray(a)


def _num_nodes(s, r, num_nodes):
    if num_nodes is not None:
        return int(num_nodes)
    return int(max(s.max(), r.max()) + 1) if s.size else 0


# ---------------------------------------------------------------------------
# graclus_cluster
# ---------------------------------------------------------------------------

def graclus_cluster(senders, receivers, weight=None, num_nodes=None,
                    seed: int = 0) -> np.ndarray:
    """Greedy weighted matching in a random node order; each node's
    cluster id is the smaller id of its matched pair (itself if
    unmatched), the reference kernel's convention."""
    s, r = as_i64(_np(senders)), as_i64(_np(receivers))
    n = _num_nodes(s, r, num_nodes)
    w = as_f64(_np(weight)) if weight is not None else None
    out = np.empty(n, dtype=np.int64)
    get_lib().graclus_cluster(ptr_i64(s), ptr_i64(r), ptr_f64(w),
                              s.shape[0], n, seed, ptr_i64(out))
    return out


def graclus_cluster_plain(senders, receivers, weight=None, num_nodes=None,
                          seed: int = 0) -> np.ndarray:
    """:func:`graclus_cluster` in numpy (its node order from numpy's
    generator)."""
    s, r = _np(senders), _np(receivers)
    n = _num_nodes(s, r, num_nodes)
    w = _np(weight)
    order = np.random.default_rng(seed).permutation(n)
    out = np.full(n, -1, dtype=np.int64)
    adj = [[] for _ in range(n)]
    ww = w if w is not None else np.ones(s.shape[0])
    for e in range(s.shape[0]):
        adj[s[e]].append((ww[e], r[e]))
    for u in order:
        if out[u] != -1:
            continue
        best, best_w = -1, -1.0
        for wv, v in adj[u]:
            if v != u and out[v] == -1 and wv > best_w:
                best_w, best = wv, v
        if best == -1:
            out[u] = u
        else:
            out[u] = out[best] = min(u, best)
    return out


# ---------------------------------------------------------------------------
# voxel_grid
# ---------------------------------------------------------------------------

def _voxel_args(pos, size, batch, start, end):
    p = as_f64(_np(pos))
    if p.ndim == 1:
        p = p[:, None]
    dim = p.shape[1]
    size = np.broadcast_to(as_f64(np.atleast_1d(size)), (dim,)).copy()
    start = as_f64(np.atleast_1d(start)) if start is not None \
        else p.min(axis=0)
    end = as_f64(np.atleast_1d(end)) if end is not None else p.max(axis=0)
    start = np.broadcast_to(start, (dim,)).copy()
    end = np.broadcast_to(end, (dim,)).copy()
    b = as_i64(_np(batch)) if batch is not None else None
    return p, size, start, end, b


def voxel_grid(pos, size, batch=None, start=None, end=None) -> np.ndarray:
    """Each point's grid cell id, batch-major (reference nn.voxel_grid)."""
    p, size, start, end, b = _voxel_args(pos, size, batch, start, end)
    n, dim = p.shape
    out = np.empty(n, dtype=np.int64)
    get_lib().voxel_grid(ptr_f64(p), n, dim, ptr_i64(b), ptr_f64(size),
                         ptr_f64(start), ptr_f64(end), ptr_i64(out))
    return out


def voxel_grid_plain(pos, size, batch=None, start=None,
                     end=None) -> np.ndarray:
    """:func:`voxel_grid` in numpy."""
    p, size, start, end, b = _voxel_args(pos, size, batch, start, end)
    cells = np.maximum(np.floor((end - start) / size).astype(np.int64) + 1,
                       1)
    c = np.clip(np.floor((p - start) / size).astype(np.int64), 0, cells - 1)
    idx = np.zeros(p.shape[0], dtype=np.int64)
    for d in range(p.shape[1]):
        idx = idx * cells[d] + c[:, d]
    if b is not None:
        idx += b * int(np.prod(cells))
    return idx


# ---------------------------------------------------------------------------
# fps
# ---------------------------------------------------------------------------

def fps(pos, batch=None, ratio: float = 0.5, random_start: bool = True,
        seed: int = 0) -> np.ndarray:
    """Farthest point sampling, ``ceil(ratio * n)`` points of each batch
    segment (reference nn.fps); global indices."""
    p = as_f64(_np(pos))
    n, dim = p.shape
    b = as_i64(_np(batch)) if batch is not None else None
    out = np.empty(n, dtype=np.int64)
    cnt = get_lib().fps(ptr_f64(p), n, dim, ptr_i64(b), float(ratio),
                        int(random_start), seed, ptr_i64(out))
    return out[:cnt]


def fps_plain(pos, batch=None, ratio: float = 0.5,
              random_start: bool = True, seed: int = 0) -> np.ndarray:
    """:func:`fps` in numpy (its random starts from numpy's generator)."""
    p = as_f64(_np(pos))
    rng = np.random.default_rng(seed)
    bs = _np(batch) if batch is not None else np.zeros(p.shape[0], np.int64)
    res = []
    for gb in np.unique(bs):
        idx = np.flatnonzero(bs == gb)
        k = max(int(np.ceil(ratio * len(idx))), 1)
        dist = np.full(len(idx), np.inf)
        cur = rng.integers(0, len(idx)) if random_start else 0
        for _ in range(k):
            res.append(idx[cur])
            d2 = np.sum((p[idx] - p[idx[cur]]) ** 2, axis=1)
            dist = np.minimum(dist, d2)
            cur = int(np.argmax(dist))
    return np.asarray(res, dtype=np.int64)


# ---------------------------------------------------------------------------
# radius, knn, knn_graph
# ---------------------------------------------------------------------------

def _pair_args(x, y, batch_x, batch_y):
    xx, yy = as_f64(_np(x)), as_f64(_np(y))
    if xx.ndim == 1:
        xx, yy = xx[:, None], yy[:, None]
    bx = as_i64(_np(batch_x)) if batch_x is not None else None
    by = as_i64(_np(batch_y)) if batch_y is not None else None
    return xx, yy, bx, by


def _candidates(xx, yy, i, bx, by):
    """(same-batch mask, squared distances to ``yy[i]``) over ``xx``."""
    m = np.ones(xx.shape[0], dtype=bool) if bx is None else (
        bx == (by[i] if by is not None else 0))
    return m, np.sum((xx - yy[i]) ** 2, axis=1)


def radius(x, y, r, batch_x=None, batch_y=None,
           max_num_neighbors: int = 32):
    """The first ``max_num_neighbors`` points of ``x`` (in index order)
    within ``r`` of each point of ``y``, in its batch segment:
    ``(row = y index, col = x index)`` (reference nn.radius)."""
    xx, yy, bx, by = _pair_args(x, y, batch_x, batch_y)
    (nx, dim), ny = xx.shape, yy.shape[0]
    row = np.empty(ny * max_num_neighbors, dtype=np.int64)
    col = np.empty(ny * max_num_neighbors, dtype=np.int64)
    cnt = get_lib().radius(ptr_f64(xx), nx, ptr_f64(yy), ny, dim,
                           ptr_i64(bx), ptr_i64(by), float(r),
                           max_num_neighbors, ptr_i64(row), ptr_i64(col))
    return row[:cnt], col[:cnt]


def radius_plain(x, y, r, batch_x=None, batch_y=None,
                 max_num_neighbors: int = 32):
    """:func:`radius` in numpy."""
    xx, yy, bx, by = _pair_args(x, y, batch_x, batch_y)
    rows, cols = [], []
    for i in range(yy.shape[0]):
        m, d2 = _candidates(xx, yy, i, bx, by)
        cand = np.flatnonzero(m & (d2 <= r * r))[:max_num_neighbors]
        rows.extend([i] * len(cand))
        cols.extend(cand.tolist())
    return (np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64))


def knn(x, y, k, batch_x=None, batch_y=None):
    """The ``k`` nearest points of ``x`` to each point of ``y``, in its
    batch segment, nearest first (ties by index): ``(row = y index,
    col = x index)``."""
    xx, yy, bx, by = _pair_args(x, y, batch_x, batch_y)
    (nx, dim), ny = xx.shape, yy.shape[0]
    row = np.empty(ny * k, dtype=np.int64)
    col = np.empty(ny * k, dtype=np.int64)
    cnt = get_lib().knn(ptr_f64(xx), nx, ptr_f64(yy), ny, dim, ptr_i64(bx),
                        ptr_i64(by), k, ptr_i64(row), ptr_i64(col))
    return row[:cnt], col[:cnt]


def knn_plain(x, y, k, batch_x=None, batch_y=None):
    """:func:`knn` in numpy: a stable sort by distance, so ties go by
    index as in the library's sort of (distance, index) pairs."""
    xx, yy, bx, by = _pair_args(x, y, batch_x, batch_y)
    rows, cols = [], []
    for i in range(yy.shape[0]):
        m, d2 = _candidates(xx, yy, i, bx, by)
        cand = np.flatnonzero(m)
        cand = cand[np.argsort(d2[cand], kind="stable")][:k]
        rows.extend([i] * len(cand))
        cols.extend(cand.tolist())
    return (np.asarray(rows, dtype=np.int64),
            np.asarray(cols, dtype=np.int64))


def _knn_graph(knn_fn, pos, k, batch, loop):
    row, col = knn_fn(pos, pos, k + (0 if loop else 1), batch, batch)
    if not loop:
        keep = row != col
        row, col = row[keep], col[keep]
    return col, row  # senders, receivers


def knn_graph(pos, k, batch=None, loop=False):
    """kNN edges within one point set: ``(senders = neighbour, receivers
    = point)``, each point's ``k`` nearest others (itself too with
    ``loop``)."""
    return _knn_graph(knn, pos, k, batch, loop)


def knn_graph_plain(pos, k, batch=None, loop=False):
    """:func:`knn_graph` over :func:`knn_plain`."""
    return _knn_graph(knn_plain, pos, k, batch, loop)


# ---------------------------------------------------------------------------
# coalesce_edges
# ---------------------------------------------------------------------------

def coalesce_edges(senders, receivers, edge_attr=None, num_nodes=None):
    """Sort by (receiver, sender) and merge duplicates, summing their
    attributes (reference torch-sparse coalesce): ``(senders, receivers,
    edge_attr or None)``."""
    s, r = as_i64(_np(senders)), as_i64(_np(receivers))
    e = s.shape[0]
    n = _num_nodes(s, r, num_nodes)
    a = _np(edge_attr)
    a2 = as_f64(a.reshape(e, -1)) if a is not None else None
    ad = a2.shape[1] if a2 is not None else 0
    s_out = np.empty(e, dtype=np.int64)
    r_out = np.empty(e, dtype=np.int64)
    a_out = np.empty((e, ad)) if a2 is not None else None
    cnt = get_lib().coalesce(ptr_i64(s), ptr_i64(r), ptr_f64(a2), e, ad, n,
                             ptr_i64(s_out), ptr_i64(r_out), ptr_f64(a_out))
    ra = None
    if a is not None:
        ra = a_out[:cnt].reshape((cnt,) + a.shape[1:]).astype(a.dtype)
    return s_out[:cnt], r_out[:cnt], ra


def coalesce_edges_plain(senders, receivers, edge_attr=None, num_nodes=None):
    """:func:`coalesce_edges` in numpy, the duplicates' attributes summed
    in float64 in input order, as the library sums them."""
    s, r = as_i64(_np(senders)), as_i64(_np(receivers))
    n = _num_nodes(s, r, num_nodes)
    a = _np(edge_attr)
    key = r * n + s
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq, first = np.unique(key, return_index=True)
    s2, r2 = s[order][first], r[order][first]
    ra = None
    if a is not None:
        seg = np.searchsorted(uniq, key)
        acc = np.zeros((uniq.shape[0],) + a.shape[1:], dtype=np.float64)
        np.add.at(acc, seg, a[order].astype(np.float64))
        ra = acc.astype(a.dtype)
    return s2, r2, ra


# ---------------------------------------------------------------------------
# sample_neighbors
# ---------------------------------------------------------------------------

def sample_neighbors(indptr, indices, seeds, k, seed: int = 0):
    """Up to ``k`` in-neighbours of each seed node, uniformly without
    replacement, over a receiver-major CSR (``indptr``, ``indices``):
    ``(senders, receivers)`` (the sampled mini-batch pipeline)."""
    ip, ix = as_i64(_np(indptr)), as_i64(_np(indices))
    sd = as_i64(_np(seeds))
    src = np.empty(sd.shape[0] * k, dtype=np.int64)
    dst = np.empty(sd.shape[0] * k, dtype=np.int64)
    cnt = get_lib().sample_neighbors(ptr_i64(ip), ptr_i64(ix), ptr_i64(sd),
                                     sd.shape[0], k, seed, ptr_i64(src),
                                     ptr_i64(dst))
    return src[:cnt], dst[:cnt]


def sample_neighbors_plain(indptr, indices, seeds, k, seed: int = 0):
    """:func:`sample_neighbors` in numpy (its draws from numpy's
    generator)."""
    ip, ix = as_i64(_np(indptr)), as_i64(_np(indices))
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for v in as_i64(_np(seeds)):
        nbrs = ix[ip[v]:ip[v + 1]]
        if len(nbrs) > k:
            nbrs = rng.choice(nbrs, size=k, replace=False)
        srcs.extend(nbrs.tolist())
        dsts.extend([int(v)] * len(nbrs))
    return (np.asarray(srcs, dtype=np.int64),
            np.asarray(dsts, dtype=np.int64))


__all__ = [
    "graclus_cluster", "voxel_grid", "fps", "radius", "knn", "knn_graph",
    "coalesce_edges", "sample_neighbors",
]
