"""Clustering / spectra visualisation.

Counterpart of ``pytorch_geometric_tpu/research/visualization.py``, host
code copied, with matplotlib and networkx imported inside the functions
(the JAX module imports both at module level; the card's machine has
neither). The graphs here are networkx graphs.

Reference counterparts: visualization.py (723 LoC) — ``run_spectral_cluster``
(:39), ``draw_clustered_mlp`` (:199), ``plot_eigenvalues`` (:399),
learning-curve plots; prune.py — Louvain ``community_layout`` (:5,
:97-103); SpectralAnalysis.py ``community_layout`` (:484).

All figures render with the Agg backend and are written to files.
"""

import os.path as osp
from typing import Dict, Sequence

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def run_spectral_cluster(weights: Sequence[np.ndarray],
                         num_clusters: int = 4, out_dir: str = "Results",
                         tag: str = "net", **kwargs) -> Dict:
    """Cluster + significance + report figure (reference
    visualization.py:39)."""
    from pytorch_geometric_tpu_torch.research.spectral_cluster import (
        run_clustering,
    )

    plt = _pyplot()
    res = run_clustering(weights, num_clusters=num_clusters, **kwargs)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(res["shuffle_ncuts"], bins=10, alpha=0.7,
                 label="shuffle null")
    axes[0].axvline(res["ncut"], color="C3", label=f"actual "
                    f"(p={res['pvalue']:.3f})")
    axes[0].set_xlabel("n-cut")
    axes[0].legend()
    counts = np.bincount(res["labels"], minlength=num_clusters)
    axes[1].bar(range(num_clusters), counts)
    axes[1].set_xlabel("cluster")
    axes[1].set_ylabel("#neurons")
    fig.suptitle(f"Spectral clustering of {tag}")
    path = osp.join(out_dir, f"spectral_cluster_{tag}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    res["figure"] = path
    return res


def community_layout(g, partition: Dict) -> Dict:
    """Two-level spring layout: communities positioned first, nodes
    within each community around its centre (reference prune.py:5-40,
    SpectralAnalysis.py:484)."""
    pos_communities = _position_communities(g, partition, scale=3.0)
    pos_nodes = _position_nodes(g, partition, scale=1.0)
    return {node: pos_communities[node] + pos_nodes[node]
            for node in g.nodes()}


def _position_communities(g, partition, **kwargs):
    import networkx as nx

    hypergraph = nx.DiGraph()
    hypergraph.add_nodes_from(set(partition.values()))
    for (ni, nj) in g.edges():
        ci, cj = partition[ni], partition[nj]
        if ci != cj:
            hypergraph.add_edge(ci, cj)
    pos_communities = nx.spring_layout(hypergraph.to_undirected(),
                                       seed=0, **kwargs)
    return {node: pos_communities[partition[node]] for node in g.nodes()}


def _position_nodes(g, partition, **kwargs):
    import networkx as nx

    communities = {}
    for node, community in partition.items():
        communities.setdefault(community, []).append(node)
    pos = {}
    for nodes in communities.values():
        subgraph = g.subgraph(nodes)
        pos.update(nx.spring_layout(subgraph, seed=0, **kwargs))
    return pos


def draw_clustered_graph(g, partition: Dict,
                         out_path: str = "Results/clustered_graph.png"):
    """Louvain-style community visualisation (reference prune.py:97-103
    uses community_louvain.best_partition + community_layout)."""
    import networkx as nx

    plt = _pyplot()
    pos = community_layout(g, partition)
    fig, ax = plt.subplots(figsize=(6, 6))
    colors = [partition[n] for n in g.nodes()]
    nx.draw(g, pos, node_color=colors, cmap="tab10", node_size=25,
            width=0.3, ax=ax)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def louvain_partition(g) -> Dict:
    """Best-effort Louvain communities via networkx (the reference uses
    python-louvain; nx >= 3 ships its own)."""
    import networkx as nx

    comms = nx.community.louvain_communities(g, seed=0)
    return {n: i for i, c in enumerate(comms) for n in c}


def plot_eigenvalues(weights: Sequence[np.ndarray],
                     out_path: str = "Results/eigenvalues.png",
                     num: int = 50):
    """Normalised-Laplacian spectrum of the weight graph (reference
    visualization.py:399)."""
    from pytorch_geometric_tpu_torch.research.spectral_cluster import (
        weights_to_graph,
    )
    import networkx as nx
    import scipy.sparse.linalg as sla

    plt = _pyplot()
    adj = weights_to_graph([np.asarray(w) for w in weights])
    lap = nx.normalized_laplacian_matrix(nx.from_scipy_sparse_array(adj))
    k = min(num, lap.shape[0] - 2)
    vals = np.sort(np.real(sla.eigsh(lap.astype(np.float64), k=k,
                                     which="SM",
                                     return_eigenvectors=False)))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(vals, marker="o", ms=3)
    ax.set_xlabel("index")
    ax.set_ylabel("eigenvalue")
    ax.set_title("Weight-graph Laplacian spectrum")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_learning_curves(curves: Dict[str, Sequence[float]],
                         out_path: str = "Results/learning_curves.png"):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, c in curves.items():
        ax.plot(np.asarray(c), label=name)
    ax.set_xlabel("epoch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
