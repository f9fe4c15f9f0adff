"""Link-prediction scorers.

Counterpart of ``pytorch_geometric_tpu/research/link_prediction.py``
(reference: the fork's vendored NetworkX algorithms, link_prediction.py
:23-512, consumed by ``WeightedLinkPrediction``, SpectralAnalysis.py
:253-289, by name).

The scorers read a graph through three idioms only: ``G[u]`` (the
neighbours of u), ``G.degree(u)`` (their count, unweighted) and
``G.nodes[u]`` (its attributes, where the community scorers find
``community``). The port's ``research/spectral.py:WeightGraph`` has
them, as a networkx graph has. Each yields ``(u, v, score)`` over
``ebunch``; with ``ebunch=None`` over every non-edge, for which
networkx is imported (host only: the card's machine has none).
"""

import math


def _pairs(G, ebunch):
    if ebunch is None:
        import networkx as nx
        return nx.non_edges(G)
    return ebunch


def _cn(G, u, v):
    return set(G[u]) & set(G[v])


def resource_allocation_index(G, ebunch=None):
    """sum over common neighbours z of 1/deg(z)."""
    for u, v in _pairs(G, ebunch):
        yield u, v, sum(1.0 / G.degree(z) for z in _cn(G, u, v)
                        if G.degree(z) > 0)


def jaccard_coefficient(G, ebunch=None):
    for u, v in _pairs(G, ebunch):
        union = len(set(G[u]) | set(G[v]))
        yield u, v, (len(_cn(G, u, v)) / union) if union else 0.0


def adamic_adar_index(G, ebunch=None):
    for u, v in _pairs(G, ebunch):
        s = 0.0
        for z in _cn(G, u, v):
            d = G.degree(z)
            if d > 1:
                s += 1.0 / math.log(d)
        yield u, v, s


def preferential_attachment(G, ebunch=None):
    for u, v in _pairs(G, ebunch):
        yield u, v, G.degree(u) * G.degree(v)


def _community(G, node, community="community"):
    try:
        return G.nodes[node][community]
    except KeyError:
        raise ValueError(
            f"node {node} has no '{community}' attribute") from None


def cn_soundarajan_hopcroft(G, ebunch=None, community="community"):
    """|cn| + bonus for common neighbours sharing u and v's community."""
    for u, v in _pairs(G, ebunch):
        cu = _community(G, u, community)
        cv = _community(G, v, community)
        cn = _cn(G, u, v)
        score = len(cn)
        if cu == cv:
            score += sum(1 for z in cn
                         if _community(G, z, community) == cu)
        yield u, v, score


def ra_index_soundarajan_hopcroft(G, ebunch=None, community="community"):
    for u, v in _pairs(G, ebunch):
        cu = _community(G, u, community)
        cv = _community(G, v, community)
        if cu != cv:
            yield u, v, 0.0
            continue
        s = sum(1.0 / G.degree(z) for z in _cn(G, u, v)
                if _community(G, z, community) == cu and G.degree(z) > 0)
        yield u, v, s


def within_inter_cluster(G, ebunch=None, delta: float = 0.001,
                         community="community"):
    if delta <= 0:
        raise ValueError("delta must be > 0")
    for u, v in _pairs(G, ebunch):
        cu = _community(G, u, community)
        cv = _community(G, v, community)
        if cu != cv:
            yield u, v, 0.0
            continue
        cn = _cn(G, u, v)
        within = {z for z in cn if _community(G, z, community) == cu}
        inter = cn - within
        yield u, v, len(within) / (len(inter) + delta)


METHODS = {
    "resource_allocation_index": resource_allocation_index,
    "jaccard_coefficient": jaccard_coefficient,
    "adamic_adar_index": adamic_adar_index,
    "preferential_attachment": preferential_attachment,
    "cn_soundarajan_hopcroft": cn_soundarajan_hopcroft,
    "ra_index_soundarajan_hopcroft": ra_index_soundarajan_hopcroft,
    "within_inter_cluster": within_inter_cluster,
}
