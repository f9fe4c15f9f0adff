"""Weight-matrix spectral analysis and the Fiedler weight correction.

Counterpart of ``pytorch_geometric_tpu/research/spectral.py``
(reference: SpectralAnalysis.py ``WeightsToAdjaency`` :43,
``Compute_fiedler_vector`` :208-217, ``Fiedler_vector_cluster``
:219-239, ``WeightedLinkPrediction`` :253-289, ``WeightCorrection``
:312-430, ``power_iteration`` :437).

The JAX module keeps its weight graphs in networkx. The card's machine
has no networkx, so this module keeps them in :class:`WeightGraph`, a
small undirected graph of its own with networkx's orders wherever a
result depends on one:

- nodes in insertion order; the neighbours of a node in the order their
  edges were first added; ``edges()`` as networkx lists them (each node's
  neighbours not listed before it); edges of weight 0 are edges;
- :func:`compose` is ``nx.compose``: the first graph's nodes and edges,
  then the second's;
- :meth:`WeightGraph.subgraph` is ``G.subgraph(nodes).copy()``, whose
  node order is the parent's, except that networkx iterates the Python
  set of the nodes when they are fewer than half the parent's (its
  ``FilterAtlas``); the same rule is kept, so the matrices and the
  clusters come out in the same order;
- :meth:`WeightGraph.to_numpy_array` is ``nx.to_numpy_array``.

The Fiedler pair (:func:`compute_fiedler_vector`) has the JAX module's
two backends: from 192 nodes the deflated power iteration of
``_fiedler_device`` in torch on ``device`` (fp32, padded to the next
power of two, the same ``default_rng(0)`` start vector, 512 iterations;
its products are torch's, as the JAX ones are XLA's, outside any Pallas
kernel), below that numpy ``eigh`` on the host. A device error raises:
there is no silent switch to the host. The correction adds its deltas to
the model's parameters in place, so an optimizer keeps its state across
it, as the JAX driver keeps ``opt_state``.
"""

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.research import link_prediction as lp
from pytorch_geometric_tpu_torch.research.pruning import _as_2d, param_items


class WeightGraph:
    """Undirected graph of weighted edges with networkx's orders (module
    docstring). ``G[u]`` is u's ``{neighbour: weight}``; ``G.nodes[u]``
    u's attribute dict; ``G.degree(u)`` its neighbour count. An edge
    added without a weight holds None and counts 1 in
    :meth:`to_numpy_array`."""

    def __init__(self):
        self._adj: Dict[int, Dict[int, Optional[float]]] = {}
        self._node: Dict[int, dict] = {}

    # -- construction ----------------------------------------------------
    def add_node(self, u, **attr):
        if u not in self._node:
            self._node[u] = {}
            self._adj[u] = {}
        self._node[u].update(attr)

    def add_nodes_from(self, nodes):
        for u in nodes:
            self.add_node(u)

    def add_edge(self, u, v, weight=None):
        self.add_node(u)
        self.add_node(v)
        self._adj[u][v] = weight
        self._adj[v][u] = weight

    def add_edges_from(self, edges):
        """``(u, v)`` or ``(u, v, weight)`` triples."""
        for e in edges:
            self.add_edge(*e)

    # -- reading ---------------------------------------------------------
    @property
    def nodes(self) -> Dict[int, dict]:
        return self._node

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __contains__(self, u):
        return u in self._node

    def __getitem__(self, u):
        return self._adj[u]

    def is_directed(self) -> bool:
        return False

    def degree(self, u) -> int:
        nbrs = self._adj[u]
        return len(nbrs) + (1 if u in nbrs else 0)

    def number_of_nodes(self) -> int:
        return len(self._node)

    def number_of_edges(self) -> int:
        loops = sum(1 for u, nbrs in self._adj.items() if u in nbrs)
        return (sum(len(n) for n in self._adj.values()) + loops) // 2

    def edges(self):
        """``(u, v, weight)`` in networkx's order."""
        seen = set()
        for u, nbrs in self._adj.items():
            for v, w in nbrs.items():
                if v not in seen:
                    yield u, v, w
            seen.add(u)

    def subgraph(self, nodes) -> "WeightGraph":
        """``G.subgraph(nodes).copy()`` of networkx, orders included."""
        keep = set(n for n in nodes if n in self._node)

        # networkx's node filter walks the kept set when it is under half
        # the parent's nodes, the parent's order otherwise; its neighbour
        # filter always walks the parent's neighbour order
        if 2 * len(keep) < len(self._node):
            order = [n for n in keep if n in self._node]
        else:
            order = [n for n in self._node if n in keep]
        sub = WeightGraph()
        for u in order:
            sub.add_node(u, **self._node[u])
        for u in order:
            nbrs = self._adj[u]
            for v in nbrs:
                if v in keep:
                    sub.add_edge(u, v, nbrs[v])
        return sub

    def to_numpy_array(self) -> np.ndarray:
        """Dense float64 matrix in node order (``nx.to_numpy_array``):
        each edge's weight (1 where it has none) at (u, v) and (v, u), 0
        where there is no edge."""
        index = {u: i for i, u in enumerate(self._node)}
        rows, cols, vals = [], [], []
        for u, v, w in self.edges():
            rows.append(index[u])
            cols.append(index[v])
            vals.append(1.0 if w is None else w)
        A = np.zeros((len(index), len(index)))
        A[rows, cols] = vals
        A[cols, rows] = vals
        return A


def compose(G: WeightGraph, H: WeightGraph) -> WeightGraph:
    """``nx.compose(G, H)``: G's nodes and edges, then H's; H's weight
    where both have an edge."""
    R = WeightGraph()
    for g in (G, H):
        for u, attr in g.nodes.items():
            R.add_node(u, **attr)
        R.add_edges_from(g.edges())
    return R


def weights_to_adjacency(weights: np.ndarray, start_node: int = 0,
                         max_edges: int = 0
                         ) -> Tuple[WeightGraph, WeightGraph]:
    """Bipartite (inputs x outputs) graph of one weight matrix, node ids
    offset by ``start_node``, rows first, then columns (reference
    WeightsToAdjaency): the weighted graph and the same edges without
    weights. ``max_edges > 0`` keeps only the largest-|w| entries, by the
    JAX function's ``argpartition``."""
    weights = np.asarray(weights)
    M, N = weights.shape
    rows, cols = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    vals = weights.reshape(-1)
    if max_edges and vals.size > max_edges:
        keep = np.argpartition(-np.abs(vals), max_edges)[:max_edges]
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    Gw, Gu = WeightGraph(), WeightGraph()
    Gw.add_nodes_from(range(start_node, start_node + M + N))
    Gu.add_nodes_from(range(start_node, start_node + M + N))
    edges = [(start_node + int(i), start_node + M + int(j), float(v))
             for i, j, v in zip(rows, cols, vals)]
    Gw.add_edges_from(edges)
    Gu.add_edges_from((u, v) for u, v, _ in edges)
    return Gw, Gu


#: Graphs below this size take the host ``eigh``, as in the JAX module.
_DEVICE_MIN_NODES = 192

#: Backend of each Fiedler pair computed, ``{"device": n, "host": m}``:
#: the pipeline reports which one served its corrections.
FIEDLER_CALLS = {"device": 0, "host": 0}


def _fiedler_device(A: np.ndarray, iters: int = 512, device="cuda"):
    """Fiedler pair of |A|'s normalised Laplacian by the JAX module's
    deflated power iteration, in fp32 torch on ``device``. With An the
    normalised adjacency of A padded to the next power of two, M v =
    mask * (v + An v) has eigenvalues 2 - eig(L) on the real rows, so its
    dominant pair is L's smallest, and one deflation gives the second.
    The start vector is ``default_rng(0).normal(size=n_pad)``, so the
    padded size is part of the result."""
    dev = resolve_device(device)
    n = A.shape[0]
    n_pad = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    Ap = np.zeros((n_pad, n_pad), np.float32)
    Ap[:n, :n] = A
    mask_np = np.zeros(n_pad, np.float32)
    mask_np[:n] = 1.0
    v2 = np.random.default_rng(0).normal(size=n_pad).astype(np.float32)
    A_t = torch.from_numpy(Ap).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    v2 = torch.from_numpy(v2).to(dev)
    d = A_t.sum(dim=1)
    dis = torch.where(d > 0, torch.rsqrt(d.clamp_min(1e-30)), 0.0)
    An = (dis[:, None] * A_t) * dis[None, :]
    An = (An + An.T) / 2.0

    def norm(v):
        return v / torch.linalg.vector_norm(v).clamp_min(1e-30)

    v1 = norm(mask)
    v2 = v2 * mask
    v2 = norm(v2 - (v1 @ v2) * v1)
    for _ in range(iters):
        v1 = norm(mask * (v1 + An @ v1))
        w2 = mask * (v2 + An @ v2)
        v2 = norm(w2 - (v1 @ w2) * v1)
    lam2 = (v2 * mask) @ v2 - v2 @ (An @ v2)
    return float(lam2), v2[:n].cpu().numpy().astype(np.float64)


def compute_fiedler_vector(G: WeightGraph, use_device: bool = None,
                           device="cuda"):
    """(algebraic connectivity, Fiedler vector) of the normalised
    Laplacian of |A| (the reference feeds signed weights, whose negative
    degrees make sqrt(d) NaN; the JAX module takes magnitudes, and so
    does this one). ``use_device`` None: the torch power iteration on
    ``device`` from 192 nodes, numpy ``eigh`` below; True or False
    forces one. A device error raises."""
    A = np.abs(G.to_numpy_array())
    n = A.shape[0]
    use = n >= _DEVICE_MIN_NODES if use_device is None else use_device
    if use:
        out = _fiedler_device(A, device=device)
        FIEDLER_CALLS["device"] += 1
        return out
    d = A.sum(axis=1)
    dis = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
    lap = np.eye(A.shape[0]) - (dis[:, None] * A) * dis[None, :]
    lap = (lap + lap.T) / 2.0
    w, v = np.linalg.eigh(lap)
    FIEDLER_CALLS["host"] += 1
    return np.real(w[1]), np.real(v[:, 1])


def fiedler_vector_cluster(G: WeightGraph, device="cuda"
                           ) -> List[WeightGraph]:
    """Split G into the two sign classes of its Fiedler vector; returns
    the induced subgraphs that have edges (reference :219-239)."""
    if G.number_of_edges() == 0:
        return [G]
    _, vec = compute_fiedler_vector(G, device=device)
    nodes = list(G.nodes)
    part_one = [nodes[i] for i in range(len(nodes)) if vec[i] < 0]
    part_two = [nodes[i] for i in range(len(nodes)) if vec[i] >= 0]
    out = []
    for part in (part_one, part_two):
        sub = G.subgraph(part)
        if sub.number_of_edges() > 0:
            out.append(sub)
    return out or [G]


def recursive_fiedler_partition(G: WeightGraph, num_classes: int,
                                device="cuda") -> Dict[int, List[int]]:
    """Recursive bipartition until at least ``num_classes`` parts
    (reference WeightCorrection's loop, :365-382)."""
    parts = [G]
    max_iter = int(math.floor(math.log(max(num_classes, 2), 2))) + 1
    it = 0
    while len(parts) < num_classes and it < max_iter:
        nxt = []
        for sub in parts:
            if sub.number_of_edges() > 0:
                nxt.extend(fiedler_vector_cluster(sub, device=device))
            else:
                nxt.append(sub)
        parts = nxt
        it += 1
    return {lab: list(sub.nodes) for lab, sub in enumerate(parts)}


def graclus_partition(G: WeightGraph, num_classes: int,
                      seed: int = 0) -> Dict[int, List[int]]:
    """Cluster the composed weight graph by repeated greedy graclus
    matching over its weighted edge list (the port's
    ``cluster.graclus_cluster``) until at most ``max(num_classes, 2)``
    clusters remain (reference SpectralAnalysis.py:18,356)."""
    from pytorch_geometric_tpu_torch.cluster import graclus_cluster

    nodes = list(G.nodes)
    idx = {u: i for i, u in enumerate(nodes)}
    s, r, w = [], [], []
    for u, v, wt in G.edges():
        if wt is not None:
            s.append(idx[u])
            r.append(idx[v])
            w.append(abs(float(wt)))
    member = np.arange(len(nodes))          # node -> current cluster id
    s, r, w = np.asarray(s), np.asarray(r), np.asarray(w)
    n = len(nodes)
    for level in range(32):
        if n <= max(num_classes, 2) or s.size == 0:
            break
        cl = graclus_cluster(s, r, weight=w, num_nodes=n,
                             seed=seed + level)
        uniq, compact = np.unique(cl, return_inverse=True)
        if len(uniq) >= n:                  # no progress: all singletons
            break
        member = compact[member]
        # coarsen the edge list; drop intra-cluster edges
        s, r = compact[s], compact[r]
        keep = s != r
        s, r, w = s[keep], r[keep], w[keep]
        n = len(uniq)
    out: Dict[int, List[int]] = {}
    for u, c in zip(nodes, member):
        out.setdefault(int(c), []).append(u)
    return {lab: mem for lab, (_, mem) in
            enumerate(sorted(out.items()))}


def weighted_link_prediction(G: WeightGraph, clusters: Dict[int, List[int]],
                             method: str, vector_pairs: int, device="cuda"
                             ) -> List[Tuple[int, int, float]]:
    """Within each cluster, repeatedly take the (argmax, argmin) Fiedler
    pair as a suspected wrong link and score it with the chosen
    link-prediction method (reference :253-289)."""
    scorer = lp.METHODS[method]
    out = []
    for nodes in clusters.values():
        sub = WeightGraph()
        sub.add_nodes_from(nodes)
        node_set = set(nodes)
        for i, j, w in G.edges():
            if i in node_set and j in node_set and w is not None:
                sub.add_edge(i, j, w)
        if sub.number_of_edges() < 2:
            continue
        _, vec = compute_fiedler_vector(sub, device=device)
        sub_nodes = list(sub.nodes)
        vec = vec.copy()
        for _ in range(vector_pairs):
            if len(vec) < 2 or vec.min() >= 0:
                break
            locx = int(np.argmax(vec))
            locy = int(np.argmin(vec))
            start, end = sub_nodes[locx], sub_nodes[locy]
            wrong = [tuple(sorted((start, end)))]
            vec = np.delete(vec, [locx, locy])
            del sub_nodes[max(locx, locy)]
            del sub_nodes[min(locx, locy)]
            for u, v, p in scorer(sub, wrong):
                out.append((u, v, float(p)))
    return out


def layer_weight_items(params) -> List[Tuple[str, np.ndarray]]:
    """``(flax path, 2-D host array)`` of every parameter whose path
    contains ``weight`` (reference: the state_dict filter,
    SpectralAnalysis.py:332-338), in ``research/pruning.py:param_items``
    order; a ``(1, a, b)`` parameter counts as its matrix."""
    items = []
    for name, leaf in param_items(params):
        arr = _as_2d(leaf)
        if arr.ndim == 2 and "weight" in name.lower():
            items.append((name, arr))
    return items


def _dump_partition(G: WeightGraph, clusters, dump: dict):
    """Write the composed graph as ``.npz`` (``nodes``; ``edges`` (E, 2);
    ``weights``, NaN for an edge without one) and the clusters as JSON,
    under ``<results_dir>/PartitionResults`` (the JAX module pickles both;
    ``research/plotting.py:plot_partition`` reads these)."""
    base = os.path.join(dump.get("results_dir", "Results"),
                        "PartitionResults")
    os.makedirs(base, exist_ok=True)
    tag = f"{dump.get('dataset', 'ds')}-{dump.get('model_name', 'model')}"
    epoch = dump.get("epoch", 0)
    edges = list(G.edges())
    np.savez(os.path.join(base, f"{tag}-GraphEpoch_{epoch}.npz"),
             nodes=np.asarray(list(G.nodes), dtype=np.int64),
             edges=np.asarray([(u, v) for u, v, _ in edges],
                              dtype=np.int64).reshape(-1, 2),
             weights=np.asarray([np.nan if w is None else w
                                 for _, _, w in edges], dtype=np.float64))
    with open(os.path.join(base, f"{tag}-oneClassNodeEpoch_{epoch}.json"),
              "w") as f:
        json.dump({str(k): [int(u) for u in v] for k, v in clusters.items()},
                  f)


def weight_correction(params, num_classes: int,
                      method: str = "resource_allocation_index",
                      vector_pairs: int = 2,
                      correction_coeff: float = 0.001,
                      max_layer_nodes: int = 2000,
                      max_layer_edges: int = 50_000,
                      clustering: str = "fiedler",
                      dump: dict = None, device=None):
    """The reference's WeightCorrection (:312-430) over a model's
    parameters (``params``: the model, or its state dict):

    1. the first two 2-D weight matrices of at most ``max_layer_nodes``
       rows + columns -> composed bipartite weight graph (at most
       ``max_layer_edges`` edges a layer);
    2. cluster it: ``clustering='fiedler'``, recursive bipartition, or
       ``'graclus'``, greedy matching over the weighted edge list;
    3. score each cluster's wrong links by link prediction;
    4. add ``correction_coeff * score`` to the matching weight entries,
       in place under ``torch.no_grad()``.

    ``device`` runs the power iterations (default: the parameters').
    Returns ``(params, corrections_applied)``."""
    items = layer_weight_items(params)
    if not items:
        return params, 0
    if device is None:
        device = param_items(params)[0][1].device
    graphs = []
    start = 0
    spans = []
    for name, w in items:
        # skip layers too wide for the dense spectral step; compose at
        # most two layers, as the reference (SpectralAnalysis.py:348)
        if sum(w.shape) > max_layer_nodes or len(graphs) >= 2:
            continue
        Gw, _ = weights_to_adjacency(w, start, max_edges=max_layer_edges)
        spans.append((name, start, w.shape))
        graphs.append(Gw)
        start += sum(w.shape)
    if not graphs:
        return params, 0
    G = graphs[0]
    for g2 in graphs[1:]:
        G = compose(G, g2)

    if clustering == "graclus":
        clusters = graclus_partition(G, num_classes)
    else:
        clusters = recursive_fiedler_partition(G, num_classes,
                                               device=device)
    if dump is not None and len(clusters) > 4:
        _dump_partition(G, clusters, dump)
    pred = weighted_link_prediction(G, clusters, method, vector_pairs,
                                    device=device)
    if not pred:
        return params, 0

    deltas = {name: np.zeros(shape) for name, _, shape in spans}
    applied = 0
    for u, v, p in pred:
        a, b = min(u, v), max(u, v)
        for name, base, (M, N) in spans:
            if base <= a < base + M and base + M <= b < base + M + N:
                deltas[name][a - base, b - base - M] += \
                    correction_coeff * p
                applied += 1

    with torch.no_grad():
        for name, leaf in param_items(params):
            if name in deltas:
                d = torch.as_tensor(deltas[name]).to(leaf.dtype)
                leaf.add_(d.reshape(leaf.shape).to(leaf.device))
    return params, applied


def eigenvalue(A, v):
    return v @ (A @ v)


def power_iteration(A, num_iters: int = 100, tol: float = 0.01):
    """Dominant eigenpair by power iteration (reference :437-452), on
    the host in numpy."""
    n, d = A.shape
    v = np.ones(d) / np.sqrt(d)
    ev = eigenvalue(A, v)
    for _ in range(num_iters):
        Av = A @ v
        v_new = Av / np.linalg.norm(Av)
        ev_new = eigenvalue(A, v_new)
        if np.abs(ev - ev_new) < tol:
            return ev_new, v_new
        v, ev = v_new, ev_new
    return ev, v
