"""Deterministic synthetic graphs with canonical benchmark shapes.

Air-gapped fallback for every dataset: when raw files are absent and the
network is unreachable, datasets materialise deterministic random graphs
whose shapes match the published corpora (Cora: 2708 nodes / 10556
directed edges / 1433 features / 7 classes, etc.).  This keeps all
examples, tests and benchmarks runnable offline with realistic sparsity
patterns; accuracy numbers on synthetic data are only smoke-level.

Class-correlated features (a planted partition) make the synthetic tasks
learnable, so convergence behaviour is qualitatively meaningful.

A copy of ``pytorch_geometric_tpu/datasets/synthetic.py`` with the same
formula. Its seed includes ``hash(name)``, which follows
``PYTHONHASHSEED``: the graph is the same for both packages within one
process, but may differ from one process to the next.
"""

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data

# name -> (num_nodes, num_undirected_edges, num_features, num_classes)
CITATION_SHAPES = {
    "cora": (2708, 5278, 1433, 7),
    "citeseer": (3327, 4552, 3703, 6),
    "pubmed": (19717, 44324, 500, 3),
    "corafull": (19793, 63421, 8710, 70),
}


def synthetic_citation_graph(name: str, seed: int = 0,
                             train_per_class: int = 20,
                             num_val: int = 500,
                             num_test: int = 1000) -> Data:
    """Planted-partition citation graph in Planetoid layout (boolean
    train/val/test masks; reference Planetoid semantics)."""
    n, e_und, f, c = CITATION_SHAPES[name.lower()]
    rng = np.random.default_rng(seed + hash(name.lower()) % (2 ** 16))
    labels = rng.integers(0, c, size=n)
    # Edges: 80% intra-class (homophily), 20% random.
    n_intra = int(e_und * 0.8)
    src = rng.integers(0, n, size=e_und)
    dst = np.empty(e_und, dtype=np.int64)
    # intra-class partners: random node of same class via per-class pools
    pools = [np.flatnonzero(labels == k) for k in range(c)]
    for i in range(n_intra):
        pool = pools[labels[src[i]]]
        dst[i] = pool[rng.integers(0, len(pool))]
    dst[n_intra:] = rng.integers(0, n, size=e_und - n_intra)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # undirected: both directions, dedup
    ei = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    key = ei[0] * n + ei[1]
    _, first = np.unique(key, return_index=True)
    ei = ei[:, first]

    # Sparse bag-of-words-ish features, class-correlated columns.
    x = np.zeros((n, f), dtype=np.float32)
    words_per_node = max(int(f * 0.01), 5)
    class_cols = rng.integers(0, f, size=(c, words_per_node))
    for i in range(n):
        cols = class_cols[labels[i]]
        noise = rng.integers(0, f, size=words_per_node // 2 + 1)
        x[i, cols] = 1.0
        x[i, noise] = 1.0

    perm = rng.permutation(n)
    train_idx = []
    for k in range(c):
        members = perm[np.isin(perm, pools[k])]
        train_idx.extend(members[:train_per_class])
    train_idx = np.asarray(train_idx)
    rest = np.setdiff1d(perm, train_idx, assume_unique=False)
    val_idx = rest[:num_val]
    test_idx = rest[num_val:num_val + num_test]

    def mask(idx):
        m = np.zeros(n, dtype=bool)
        m[idx] = True
        return m

    return Data(x=x, edge_index=ei, y=labels.astype(np.int64),
                train_mask=mask(train_idx), val_mask=mask(val_idx),
                test_mask=mask(test_idx))
