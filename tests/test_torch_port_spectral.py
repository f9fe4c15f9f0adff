"""Port parity, the spectral weight correction: ``research/spectral.py``
against the JAX module on the same numpy weights.

- ``WeightGraph`` against networkx (imported here only): node order,
  ``compose``, ``subgraph`` (under and over half the parent's nodes,
  where networkx's order rules differ), the edge order, degrees and
  ``to_numpy_array``; ``weights_to_adjacency`` with and without
  ``max_edges``;
- the host ``eigh`` Fiedler pair bitwise; the torch power iteration on
  the CPU against the JAX ``_fiedler_device`` at sizes that pad
  differently (191, 192 and 300 nodes: 256, 256 and 512), λ2 within
  1e-5 and the vector within 1e-5 of its largest entry (the JAX one is
  XLA's fp32 products, the port's torch's); a device error raises, with
  no switch to the host and no state kept;
- the recursive Fiedler and graclus partitions, the link-prediction
  pairs (1e-12), and ``weight_correction``'s ``applied`` and corrected
  parameters exactly (resource allocation, whose scores of input-output
  pairs are 0, and preferential attachment, whose are not), on a model whose composed graph has 170 nodes
  (the host path), with and without an edge cap, for both clusterings;
  the partition dump read back by ``plotting.plot_partition``."""

import jax
import networkx as nx
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.models import prunable as jprunable
from pytorch_geometric_tpu.research import spectral as jspectral
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.models.prunable import choose_model
from pytorch_geometric_tpu_torch.research import plotting, spectral
from pytorch_geometric_tpu_torch.research.spectral import (
    WeightGraph, compose, weights_to_adjacency)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The power iteration is thousands of small products: one torch
    thread each, so that workers running beside this file do not make
    every product wait on a crowded thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed, m=20, n=12, m2=12, n2=5, max_edges=100):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(m, n)).astype(np.float32)
    w2 = rng.normal(size=(m2, n2)).astype(np.float32)
    G, _ = weights_to_adjacency(w1, 0, max_edges=max_edges)
    H, _ = weights_to_adjacency(w2, m + n)
    Gj, _ = jspectral.weights_to_adjacency(w1, 0, max_edges=max_edges)
    Hj, _ = jspectral.weights_to_adjacency(w2, m + n)
    return compose(G, H), nx.compose(Gj, Hj)


def _edges(G):
    return [(u, v, d["weight"]) for u, v, d in G.edges(data=True)] \
        if isinstance(G, nx.Graph) else list(G.edges())


def _same_graph(W, G):
    assert list(W.nodes) == list(G.nodes())
    assert _edges(W) == _edges(G)
    assert {u: list(W[u]) for u in W} == {u: list(G[u]) for u in G}
    assert [W.degree(u) for u in W] == [G.degree(u) for u in G]
    assert W.number_of_edges() == G.number_of_edges()
    assert np.array_equal(W.to_numpy_array(),
                          nx.to_numpy_array(G, weight="weight"))


@pytest.mark.parametrize("seed", [0, 1])
def test_weight_graph_matches_networkx(seed):
    W, G = _pair(seed)
    _same_graph(W, G)
    rng = np.random.default_rng(seed)
    n = len(G)
    for size in (3, 10, n // 2 - 1, n // 2 + 1, n - 2):
        part = [int(u) for u in rng.permutation(n)[:size]]
        _same_graph(W.subgraph(part), G.subgraph(part).copy())
    # without a cap every entry is an edge, zeros included
    w = np.zeros((3, 2), np.float32)
    Gw, Gu = weights_to_adjacency(w, 5)
    Jw, Ju = jspectral.weights_to_adjacency(w, 5)
    _same_graph(Gw, Jw)
    assert list(Gu.nodes) == list(Ju.nodes())
    assert np.array_equal(Gu.to_numpy_array(), nx.to_numpy_array(Ju))


def test_fiedler_host_path_is_the_jax_one_bitwise():
    W, G = _pair(2)
    lam, vec = spectral.compute_fiedler_vector(W)
    jlam, jvec = jspectral.compute_fiedler_vector(G)
    assert lam == jlam and np.array_equal(vec, jvec)
    sub = [int(u) for u in list(G.nodes())[::3]]
    lam, vec = spectral.compute_fiedler_vector(W.subgraph(sub))
    jlam, jvec = jspectral.compute_fiedler_vector(G.subgraph(sub).copy())
    assert lam == jlam and np.array_equal(vec, jvec)


@pytest.mark.parametrize("n", [191, 192, 300])
def test_fiedler_power_iteration_matches_the_jax_device_path(n):
    rng = np.random.default_rng(n)
    A = np.abs(rng.normal(size=(n, n))) * (rng.random((n, n)) < 0.05)
    A = np.triu(A, 1)
    A = A + A.T
    jlam, jvec = jspectral._fiedler_device(A)
    lam, vec = spectral._fiedler_device(A, device="cpu")
    assert abs(lam - jlam) <= 1e-5
    assert vec.dtype == np.float64 and vec.shape == (n,)
    np.testing.assert_allclose(vec, jvec, rtol=0,
                               atol=1e-5 * np.abs(jvec).max())
    # through the public entry on a weight graph: the device path from
    # 192 nodes on, and on request below
    W = WeightGraph()
    W.add_nodes_from(range(n))
    r, c = np.nonzero(np.triu(A, 1))
    W.add_edges_from((int(i), int(j), float(A[i, j])) for i, j in zip(r, c))
    before = dict(spectral.FIEDLER_CALLS)
    lam2, vec2 = spectral.compute_fiedler_vector(
        W, use_device=True if n < 192 else None, device="cpu")
    assert spectral.FIEDLER_CALLS["device"] == before["device"] + 1
    np.testing.assert_allclose(vec2, jvec, rtol=0,
                               atol=1e-5 * np.abs(jvec).max())


def test_a_device_error_raises_and_keeps_no_state(monkeypatch):
    W, _ = _pair(3, m=120, n=80)                 # 217 nodes: device path
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spectral.compute_fiedler_vector(W, device="cuda")
    calls = []

    def broken(A, iters=512, device="cuda"):
        calls.append(A.shape[0])
        raise RuntimeError("device lost")

    monkeypatch.setattr(spectral, "_fiedler_device", broken)
    for _ in range(2):          # no fallback flag: each call tries again
        with pytest.raises(RuntimeError, match="device lost"):
            spectral.compute_fiedler_vector(W, device="cpu")
    assert calls == [217, 217]
    with pytest.raises(RuntimeError, match="device lost"):
        spectral.weight_correction(_gcn(widths=(80, 60), f_in=60)[1], 4,
                                   device="cpu")


def _gcn(seed=0, widths=(50, 30), f_in=40):
    """A JAX ``PrunableGCN``'s variables and the port model carrying
    them: layers (40, 50), (50, 30), (30, 7), so the first two compose
    into a graph of 170 nodes."""
    from pytorch_geometric_tpu.data import Data as JData
    from pytorch_geometric_tpu.data import from_data as j_from_data

    rng = np.random.default_rng(seed)
    n = 12
    jg = j_from_data(JData(
        x=rng.random((n, f_in)).astype(np.float32),
        edge_index=np.stack([rng.integers(0, n, 30),
                             rng.integers(0, n, 30)])))
    key = jax.random.PRNGKey(seed)
    jmodel = jprunable.choose_model("GCN", widths, 7)
    params = jax.jit(jmodel.init)({"params": key, "dropout": key}, jg, jg.x)
    model = choose_model("GCN", widths, 7, in_channels=f_in)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("max_layer_edges", [50_000, 1200])
@pytest.mark.parametrize("clustering", ["fiedler", "graclus"])
def test_weight_correction_matches_jax(clustering, max_layer_edges,
                                       tmp_path):
    params, model = _gcn()
    items = spectral.layer_weight_items(model)
    jitems = jspectral.layer_weight_items(params)
    assert [n for n, _ in items] == [n for n, _ in jitems]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(items, jitems))
    # the composed graph, its partition and the scored pairs
    graphs, jgraphs, start = [], [], 0
    for (_, w), (_, jw) in zip(items[:2], jitems[:2]):
        graphs.append(weights_to_adjacency(w, start, max_layer_edges)[0])
        jgraphs.append(jspectral.weights_to_adjacency(
            jw, start, max_layer_edges)[0])
        start += sum(w.shape)
    W, G = compose(*graphs), nx.compose(*jgraphs)
    _same_graph(W, G)
    if clustering == "graclus":
        clusters = spectral.graclus_partition(W, 7)
        jclusters = jspectral.graclus_partition(G, 7)
    else:
        clusters = spectral.recursive_fiedler_partition(W, 7, device="cpu")
        jclusters = jspectral.recursive_fiedler_partition(G, 7)
    assert clusters == jclusters and len(clusters) > 4
    pred = spectral.weighted_link_prediction(
        W, clusters, "resource_allocation_index", 2, device="cpu")
    jpred = jspectral.weighted_link_prediction(
        G, jclusters, "resource_allocation_index", 2)
    assert [p[:2] for p in pred] == [p[:2] for p in jpred] and pred
    np.testing.assert_allclose([p[2] for p in pred], [p[2] for p in jpred],
                               rtol=1e-12, atol=1e-12)

    # a common-neighbour score of an input-output pair of a bipartite
    # graph is 0, so resource_allocation_index applies zeros (the
    # reference's own result); preferential attachment moves weights
    for method in ("resource_allocation_index", "preferential_attachment"):
        params, model = _gcn()
        kw = dict(num_classes=7, method=method, vector_pairs=2,
                  correction_coeff=1e-3, max_layer_edges=max_layer_edges,
                  clustering=clustering)
        jnew, japplied = jspectral.weight_correction(params, **kw)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        out, applied = spectral.weight_correction(
            model, dump={"results_dir": str(tmp_path), "dataset": "Toy",
                         "model_name": "GCN", "epoch": 3}, **kw)
        assert out is model and applied == japplied > 0
        want = params_from_jax(jnew)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
        moved = any(not torch.equal(before[k], v)
                    for k, v in model.state_dict().items())
        assert moved == (method == "preferential_attachment")

    # the dump: the graph as .npz, the clusters as JSON, drawn
    base = tmp_path / "PartitionResults"
    assert sorted(p.name for p in base.iterdir()) == [
        "Toy-GCN-GraphEpoch_3.npz", "Toy-GCN-oneClassNodeEpoch_3.json"]
    with np.load(base / "Toy-GCN-GraphEpoch_3.npz") as z:
        assert list(z["nodes"]) == list(W.nodes)
        assert [tuple(e) for e in z["edges"]] == [e[:2] for e in W.edges()]
    out_png = tmp_path / "partition.png"
    plotting.plot_partition(str(tmp_path), "Toy", "GCN", 3, str(out_png))
    assert out_png.stat().st_size > 0


def test_power_iteration_matches_jax():
    A = np.random.default_rng(0).normal(size=(6, 6))
    A = A @ A.T
    for tol in (0.01, 1e-9):
        ev, v = spectral.power_iteration(A, tol=tol)
        jev, jv = jspectral.power_iteration(A, tol=tol)
        assert ev == jev and np.array_equal(v, jv)
