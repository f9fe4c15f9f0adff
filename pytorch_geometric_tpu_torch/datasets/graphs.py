"""The graphs the port is run and measured on, as ``chip_smoke.py`` and
the kernel probes under ``probes/`` build them. No data file is needed:
the datasets synthesise the corpora's published shapes where the raw
files are absent under the repository's ``datasets_cache*`` directories,
and nothing is written there.

- :func:`cora_graph`: Planetoid Cora, features normalised.
- :func:`pubmed_data` / :func:`pubmed_graph`: Planetoid PubMed ->
  ``NormalizeFeatures`` -> ``reorder_graph`` (RCM) -> ``from_data``, the
  graph of ``examples/gat.py --dataset PubMed --backend bsr`` and of the
  JAX package's ``tools/gat_sweep.py:build_graph`` (24,576 padded nodes).
- :func:`mutag_data` / :func:`mutag_graph`: ``Entities("MUTAG")``;
  ``order="as_trained"`` is the order ``train_rgcn`` trains on (the port
  does not reorder MUTAG), ``order="rcm"`` relabels ``edge_index``, ``y``,
  ``train_idx`` and ``test_idx`` by ``rcm_permutation`` as
  ``tools/rgcn_sweep.py:build_graph`` does.
- :func:`bsr_synthetic_masks`: two directed masks, as entry lists, on
  which the block-sparse GAT kernels meet a block-dense mask and hub rows.
- :func:`flash_synthetic_masks`: two dense directed masks, on which the
  dense-mask GAT kernels meet a half-full mask and the operator's cap.
- :func:`gat_hub_edges`: a GAT edge set with a receiver hub and a sender
  hub, on which the packed-GAT kernels meet hub rows on both sides.
- :func:`spmm_hub_operator`: the same edges as an ``SpmmOperator`` with
  random weights, on which ``spmm_csr`` meets them.
- :func:`rgcn_hub_operator`: a relational operator with hub rows on both
  sides and a dominant relation, for the packed-RGCN kernels.
- :func:`gen_clustered`: the community-structured, locality-ordered
  graph of the JAX package's scale benchmark (``bench_scale.py:51-66``),
  on which the block SpMM's dense blocks meet Reddit's size.
"""

import time
from pathlib import Path

import numpy as np

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets.molecules import Entities
from pytorch_geometric_tpu_torch.datasets.planetoid import Planetoid
from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures
from pytorch_geometric_tpu_torch.utils.reorder import (
    rcm_permutation, reorder_graph)

_REPO = Path(__file__).resolve().parents[2]
PLANETOID_ROOT = _REPO / "datasets_cache"
MUTAG_ROOT = _REPO / "datasets_cache_fullmutag"
ORDERS = ("rcm", "as_trained")


def cora_graph(device="cuda"):
    """``(dataset, graph on device)`` of Planetoid Cora, features
    normalised."""
    ds = Planetoid(str(PLANETOID_ROOT), "Cora",
                   transform=NormalizeFeatures())
    return ds, from_data(ds[0], device=device)


def pubmed_data(name: str = "PubMed", reorder: bool = True):
    """``(dataset, host Data, seconds the RCM relabelling took)``:
    Planetoid ``name``, features normalised, nodes relabelled by RCM."""
    ds = Planetoid(str(PLANETOID_ROOT), name, transform=NormalizeFeatures())
    data = ds[0]
    t0 = time.perf_counter()
    if reorder:
        data = reorder_graph(data)
    return ds, data, time.perf_counter() - t0


def pubmed_graph(device="cuda", reorder: bool = True, name: str = "PubMed"):
    """``(dataset, graph on device, RCM seconds)`` of :func:`pubmed_data`."""
    ds, data, seconds = pubmed_data(name, reorder)
    return ds, from_data(data, device=device), seconds


def mutag_data(order: str = "as_trained", scale: float = 1.0):
    """``(dataset, host Data)`` of MUTAG-RDF at ``scale`` in ``order``
    (one of :data:`ORDERS`)."""
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    ds = Entities(str(MUTAG_ROOT), "MUTAG", scale=scale)
    data = ds[0]
    if order == "rcm":
        ei = np.asarray(data.edge_index)
        n = data.num_nodes
        perm = rcm_permutation(ei[0], ei[1], n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        data.edge_index = inv[ei]
        data.y = np.asarray(data.y)[perm]
        data.train_idx = inv[np.asarray(data.train_idx)]
        data.test_idx = inv[np.asarray(data.test_idx)]
    return ds, data


def mutag_graph(device="cuda", order: str = "as_trained",
                scale: float = 1.0):
    """``(dataset, graph on device)`` of :func:`mutag_data`."""
    ds, data = mutag_data(order, scale)
    return ds, from_data(data, device=device)


def bsr_synthetic_masks(seed: int = 0):
    """(name, senders, receivers, n, (H, C) pairs, timed calls) of two
    directed block-sparse masks, as entry lists (no (N, N) array), from
    ``np.random.default_rng(seed)``:

    - ``blocks16384``, above the dense operator's cap: 128 communities of
      128 nodes, each half full, plus 16k random entries; rows 100-139
      and columns 300-349 hold nothing;
    - ``hub5003``, a node count that no tile divides: about four entries
      a row and the diagonal, and 3000 random entries in row 3 and in
      column 10 (about 2,240 distinct each)."""
    rng = np.random.default_rng(seed)
    n, size = 16384, 128
    blk, r, c = np.nonzero(rng.random((n // size, size, size)) < 0.5)
    rows = np.concatenate([blk * size + r, rng.integers(0, n, 16384)])
    cols = np.concatenate([blk * size + c, rng.integers(0, n, 16384)])
    keep = ~(((rows >= 100) & (rows < 140)) | ((cols >= 300) & (cols < 350)))
    m = 5003
    hub_rows = np.concatenate([np.repeat(np.arange(m), 4), np.arange(m),
                               np.full(3000, 3), rng.integers(0, m, 3000)])
    hub_cols = np.concatenate([rng.integers(0, m, 4 * m), np.arange(m),
                               rng.integers(0, m, 3000), np.full(3000, 10)])
    return (("blocks16384", cols[keep], rows[keep], n, ((8, 8),), 10),
            ("hub5003", hub_cols, hub_rows, m, ((8, 8), (3, 5)), 50))


def flash_synthetic_masks(seed: int = 0):
    """(name, dense (n, n) boolean numpy mask) of two directed masks for
    the dense-mask GAT operator, from ``np.random.default_rng(seed)``:

    - ``half2048``: half full, 2048 nodes, rows 0, 77, 2047 and columns 5,
      1000, 2046 empty;
    - ``cap8192``: the operator's cap (``ops/flash_gat.py:MAX_NODES``),
      8192 nodes with PubMed's edges per node (undirected pairs made
      symmetric) and self loops."""
    from pytorch_geometric_tpu_torch.ops.flash_gat import MAX_NODES

    rng = np.random.default_rng(seed)
    half = rng.random((2048, 2048)) < 0.5
    half[[0, 77, 2047], :] = False
    half[:, [5, 1000, 2046]] = False
    n = MAX_NODES
    pairs = rng.integers(0, n, (2, n * 44324 // 19717))
    cap = np.zeros((n, n), dtype=bool)
    cap[pairs[0], pairs[1]] = cap[pairs[1], pairs[0]] = True
    np.fill_diagonal(cap, True)
    return (("half2048", half), ("cap8192", cap))


def gat_hub_edges(n: int = 512, seed: int = 8):
    """(senders, receivers) of a packed-GAT edge set of ``n`` nodes, from
    ``np.random.default_rng(seed)``: unique (receiver, sender) pairs in
    receiver-major order with one self loop per node, plus a receiver hub
    (row 3: 500 senders) and a sender hub (node 10: 400 receivers), and
    rows with no edges but their loop (nodes n-40 and up)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, 4000)
    r = rng.integers(0, n - 40, 4000)
    s = np.concatenate([s, np.arange(500), np.full(400, 10), np.arange(n)])
    r = np.concatenate([r, np.full(500, 3), np.arange(400), np.arange(n)])
    key = np.unique(r * n + s)
    return key % n, key // n


def spmm_hub_operator(device="cuda", seed: int = 0):
    """``(SpmmOperator, weights)`` over :func:`gat_hub_edges` (512 nodes, a
    receiver row of 501 edges, a sender row of 402), the weights normal
    from ``np.random.default_rng(seed)``, in edge order (route them with
    ``SpmmOperator.route_weights``)."""
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    senders, receivers = gat_hub_edges()
    weights = np.random.default_rng(seed).normal(size=senders.shape)
    return (SpmmOperator(senders, receivers, 512, device=device),
            weights.astype(np.float32))


def rgcn_hub_operator(device="cuda", seed: int = 0):
    """A ``PackedRgcnSpmm`` whose rows are far from uniform, from
    ``np.random.default_rng(seed)``: node 3 receives 3000 edges, node 10
    sends 2500, relation 2 holds nine edges in ten, with duplicate edges
    and nodes that have none; 4096 nodes, 7 relations, 4200 source rows
    (embed mode)."""
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import PackedRgcnSpmm

    n, R, e = 4096, 7, 30000
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.integers(0, n - 100, e + 3000),
                        np.full(2500, 10)])
    r = np.concatenate([rng.integers(0, n - 100, e), np.full(3000, 3),
                        rng.integers(0, n - 100, 2500)])
    et = rng.integers(0, R, s.shape[0])
    et = np.where(rng.random(s.shape[0]) < 0.9, 2, et)
    s[:100], r[:100], et[:100] = s[100:200], r[100:200], et[100:200]
    w = (rng.random(s.shape[0]) + 0.1).astype(np.float32)
    return PackedRgcnSpmm(s, r, et, R, n, w, num_src_rows=4200,
                          device=device)


#: Reddit's published size (the GraphSAGE release: 232,965 nodes,
#: 114,615,892 directed edges, 602 features, 41 classes), the scale
#: benchmark's graph (``bench_scale.py:45-48``).
REDDIT_N, REDDIT_E, REDDIT_F, REDDIT_C = 232_965, 114_615_892, 602, 41


def gen_clustered(n, e, communities, seed=0):
    """Community-structured synthetic graph, locality-ordered: each node
    in one of ``communities`` (uniform), the nodes numbered community by
    community; ``e`` edges from uniform senders, 90% of them to a uniform
    receiver of the sender's community, the rest to any node. Returns
    ``(senders, receivers, community of each node in the new order)``,
    the JAX package's generator (``bench_scale.py:51-66``) draw for
    draw."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[np.argsort(comm, kind="stable")] = np.arange(n)
    starts = np.searchsorted(np.sort(comm), np.arange(communities))
    counts = np.bincount(comm, minlength=communities)
    src = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    c = comm[src]
    dst = np.where(intra,
                   starts[c] + (rng.random(e) * counts[c]).astype(
                       np.int64),
                   rng.integers(0, n, e))
    return pos_of[src], dst, comm[np.argsort(pos_of, kind="stable")]
