"""MLP weight-graph spectral clustering + significance testing.

Counterpart of ``pytorch_geometric_tpu/research/spectral_cluster.py``,
host code copied (numpy and scipy; sklearn imported inside
``cluster_net``, the card's machine has none).

Reference counterpart: spectral_cluster_model.py (1069 LoC) — weights ->
block-tridiagonal sparse graph (``weights_to_graph`` :402), spectral
clustering of the |W| graph, n-cut quality (``ncut``/``cut_vol``
:596-737), shuffle-null significance testing (``shuffle_and_cluster``
:870-950 + ``compute_pvalue`` in Results/utils.py:185), pipeline
``run_clustering`` (:952).

Implementation notes: scipy.sparse + sklearn SpectralClustering replace
the reference's identical stack; shuffle methods 'layer' (full
permutation) and 'layer_nonzero' (permute nonzero entries in place)
cover the methods the pipeline defaults to.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


def weights_to_layer_widths(weights: Sequence[np.ndarray]) -> List[int]:
    widths = [weights[0].shape[0]]
    for w in weights:
        widths.append(w.shape[1])
    return widths


def weights_to_graph(weights: Sequence[np.ndarray]) -> sp.csr_matrix:
    """Block-tridiagonal |W| adjacency over all neurons (reference
    :402)."""
    widths = weights_to_layer_widths(weights)
    n = sum(widths)
    offs = np.cumsum([0] + widths)
    rows, cols, vals = [], [], []
    for l, w in enumerate(weights):
        aw = np.abs(np.asarray(w))
        r, c = np.nonzero(aw)
        rows.append(r + offs[l])
        cols.append(c + offs[l + 1])
        vals.append(aw[r, c])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    adj = sp.coo_matrix(
        (np.concatenate([vals, vals]),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n)).tocsr()
    return adj


def cluster_net(num_clusters: int, adj: sp.csr_matrix,
                assign_labels: str = "kmeans", seed: int = 0):
    from sklearn.cluster import SpectralClustering

    alg = SpectralClustering(n_clusters=num_clusters, affinity="precomputed",
                             assign_labels=assign_labels, random_state=seed)
    return alg.fit(adj).labels_


def ncut(weights: Sequence[np.ndarray], num_clusters: int,
         labels: np.ndarray, epsilon: float = 1e-8) -> float:
    """sum_k cut(k) / (vol(k) + eps) over the weight graph (reference
    :596-601)."""
    widths = weights_to_layer_widths(weights)
    offs = np.cumsum([0] + widths)
    cut = np.zeros(num_clusters)
    vol = np.zeros(num_clusters)
    for l, w in enumerate(weights):
        aw = np.abs(np.asarray(w))
        r, c = np.nonzero(aw)
        lr = labels[r + offs[l]]
        lc = labels[c + offs[l + 1]]
        v = aw[r, c]
        np.add.at(vol, lr, v)
        np.add.at(vol, lc, v)
        diff = lr != lc
        np.add.at(cut, lr[diff], v[diff])
        np.add.at(cut, lc[diff], v[diff])
    return float(np.sum(cut / (vol + epsilon)))


def delete_isolated_ccs(weights: Sequence[np.ndarray],
                        adj: sp.csr_matrix):
    """Drop connected components not spanning input and output layers
    (reference :799-860 semantics)."""
    nc, labels = sp.csgraph.connected_components(adj, directed=False)
    if nc == 1:
        return list(weights), adj
    widths = weights_to_layer_widths(weights)
    offs = np.cumsum([0] + widths)
    initial = set(labels[: widths[0]])
    final = set(labels[offs[-2]: offs[-1]])
    keep_ccs = initial & final
    keep = np.isin(labels, list(keep_ccs))
    new_weights = []
    for l, w in enumerate(weights):
        rk = keep[offs[l]: offs[l + 1]]
        ck = keep[offs[l + 1]: offs[l + 2]]
        new_weights.append(np.asarray(w)[np.ix_(rk, ck)])
    return new_weights, weights_to_graph(new_weights)


def shuffle_weights(w: np.ndarray, rng) -> np.ndarray:
    """Full permutation of all entries (reference shuffle_method
    'layer')."""
    flat = np.asarray(w).reshape(-1).copy()
    rng.shuffle(flat)
    return flat.reshape(np.asarray(w).shape)


def shuffle_weights_nonzero(w: np.ndarray, rng) -> np.ndarray:
    """Permute nonzero entries among nonzero positions ('layer_nonzero')."""
    w = np.asarray(w).copy()
    nz = np.nonzero(w)
    vals = w[nz].copy()
    rng.shuffle(vals)
    w[nz] = vals
    return w


SHUFFLE_METHODS = {"layer": shuffle_weights,
                   "layer_nonzero": shuffle_weights_nonzero}


def _null_sample(args) -> float:
    """One shuffle-null draw (module-level so process pools can pickle
    it)."""
    weights, num_clusters, shuffle_method, delete_isolated, epsilon, \
        sample_seed = args
    rng = np.random.default_rng(sample_seed)
    fn = SHUFFLE_METHODS[shuffle_method]
    shuffled = [fn(w, rng) for w in weights]
    adj = weights_to_graph(shuffled)
    if delete_isolated:
        shuffled, adj = delete_isolated_ccs(shuffled, adj)
    labels = cluster_net(num_clusters, adj, seed=sample_seed % (2**31))
    return ncut(shuffled, num_clusters, labels, epsilon)


def shuffle_and_cluster(weights: Sequence[np.ndarray], num_clusters: int,
                        num_samples: int = 20,
                        shuffle_method: str = "layer",
                        delete_isolated: bool = True,
                        epsilon: float = 1e-8, seed: int = 0,
                        num_workers: int = None) -> np.ndarray:
    """Null distribution of n-cuts over shuffled weights (reference
    :870-950).  Samples are independent (per-sample seeds derived from
    ``seed``), so they run on a process pool — the reference used a
    pathos multiprocess map for the same loop
    (spectral_cluster_model.py:870-950).  ``num_workers=None`` sizes
    the pool to min(cpu_count, num_samples); ``<= 1`` runs serial.
    Deterministic given ``seed`` regardless of worker count."""
    import os

    seeds = np.random.default_rng(seed).integers(
        2 ** 31, size=num_samples)
    tasks = [(list(weights), num_clusters, shuffle_method,
              delete_isolated, epsilon, int(s)) for s in seeds]
    if num_workers is None:
        num_workers = min(os.cpu_count() or 1, num_samples)
    if num_workers <= 1 or num_samples <= 1:
        return np.asarray([_null_sample(t) for t in tasks])
    # spawn, not fork: fork() from a threaded process (torch's
    # thread pools) can deadlock the children
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(max_workers=num_workers,
                             mp_context=mp.get_context("spawn")) as ex:
        return np.asarray(list(ex.map(_null_sample, tasks)))


def compute_pvalue(actual: float, null_samples: np.ndarray) -> float:
    """One-sided p-value of the actual n-cut under the shuffle null
    (reference Results/utils.py:185; smaller ncut = more clusterable)."""
    null_samples = np.asarray(null_samples)
    return float((np.sum(null_samples <= actual) + 1)
                 / (len(null_samples) + 1))


def run_clustering(weights: Sequence[np.ndarray], num_clusters: int = 4,
                   num_shuffle_samples: int = 20,
                   shuffle_method: str = "layer",
                   delete_isolated: bool = True, epsilon: float = 1e-8,
                   seed: int = 0, num_workers: int = None) -> Dict:
    """The full pipeline (reference run_clustering :952): cluster the
    real weight graph, build the shuffle null, report the p-value."""
    weights = [np.asarray(w) for w in weights]
    adj = weights_to_graph(weights)
    if delete_isolated:
        weights2, adj = delete_isolated_ccs(weights, adj)
    else:
        weights2 = weights
    labels = cluster_net(num_clusters, adj, seed=seed)
    actual = ncut(weights2, num_clusters, labels, epsilon)
    null = shuffle_and_cluster(weights2, num_clusters,
                               num_shuffle_samples, shuffle_method,
                               delete_isolated, epsilon, seed,
                               num_workers=num_workers)
    return {
        "ncut": actual,
        "labels": labels,
        "shuffle_ncuts": null,
        "null_mean": float(null.mean()) if len(null) else None,
        "null_std": float(null.std()) if len(null) else None,
        "pvalue": compute_pvalue(actual, null),
        "zscore": float((actual - null.mean()) / (null.std() + 1e-12))
        if len(null) else None,
    }
