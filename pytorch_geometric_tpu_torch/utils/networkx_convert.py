"""networkx conversions: ``to_networkx`` and ``from_networkx``.

Counterpart of ``pytorch_geometric_tpu/utils/networkx_convert.py``
(reference: torch_geometric.utils.to_networkx / from_networkx). networkx
is imported inside the functions, so that the package imports on a
machine without it.
"""

import numpy as np


def to_networkx(data_or_graph, node_attrs=None, edge_attrs=None,
                to_undirected: bool = False):
    """Host ``Data`` or padded ``Graph`` -> networkx (real nodes and edges
    only; ``edge_attrs`` is accepted and unused, as in the JAX
    package)."""
    import networkx as nx

    from pytorch_geometric_tpu_torch.data.graph import Graph

    if isinstance(data_or_graph, Graph):
        g = data_or_graph
        nm = g.real_node_mask().cpu().numpy()
        em = g.real_edge_mask().cpu().numpy()
        senders = g.senders.cpu().numpy()[em]
        receivers = g.receivers.cpu().numpy()[em]
        n = int(nm.sum())
        x = None if g.x is None else g.x.detach().cpu().numpy()
    else:
        senders, receivers = data_or_graph.edge_index
        n = data_or_graph.num_nodes
        x = data_or_graph.x

    G = nx.Graph() if to_undirected else nx.DiGraph()
    G.add_nodes_from(range(n))
    if x is not None and node_attrs:
        for key in node_attrs:
            vals = x if key == "x" else getattr(data_or_graph, key, None)
            if vals is not None:
                for i in range(n):
                    G.nodes[i][key] = np.asarray(vals[i])
    G.add_edges_from(zip(senders.tolist(), receivers.tolist()))
    return G


def from_networkx(G):
    """networkx -> host ``Data`` (an undirected graph's edges in both
    directions)."""
    from pytorch_geometric_tpu_torch.data.data import Data

    mapping = {n: i for i, n in enumerate(G.nodes())}
    edges = [(mapping[u], mapping[v]) for u, v in G.edges()]
    if not G.is_directed():
        edges = edges + [(v, u) for u, v in edges]
    if edges:
        ei = np.asarray(edges, dtype=np.int64).T
    else:
        ei = np.zeros((2, 0), dtype=np.int64)
    d = Data(edge_index=ei)
    d.num_nodes = G.number_of_nodes()
    return d
