"""Locality-aware node reordering, on the host (numpy and scipy).

Counterpart of ``pytorch_geometric_tpu/utils/reorder.py``, with the same
permutation for the same edges. Reverse Cuthill-McKee relabels the nodes
so that neighbours get nearby ids and the adjacency's entries gather near
the diagonal. In the port that matters to one operator: the block-sparse
GAT attention (``ops/bsr_gat.py``), whose mask holds only the blocks with
an entry, so fewer active blocks mean fewer mask words to read. The
edge-list and dense-mask operators compute the same result for any node
order and gain nothing from it.
"""

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def rcm_permutation(senders, receivers, num_nodes: int) -> np.ndarray:
    """``perm[new_id] = old_id`` by reverse Cuthill-McKee on the
    symmetrised graph."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    adj = sp.coo_matrix(
        (np.ones(len(senders)), (senders, receivers)),
        shape=(num_nodes, num_nodes))
    adj = adj + adj.T
    return np.asarray(sp.csgraph.reverse_cuthill_mckee(adj.tocsr(),
                                                       symmetric_mode=True))


def reorder_graph(data, perm: np.ndarray = None):
    """Relabel a host ``Data``'s nodes by ``perm`` (new -> old; RCM of its
    edges if not given), in place: every node-level array (x, pos, y, the
    masks) and the edge endpoints. Returns ``data``."""
    if perm is None:
        perm = rcm_permutation(data.edge_index[0], data.edge_index[1],
                               data.num_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    for key, value in list(data()):
        if key != "edge_index" and data.is_node_level(key, value):
            setattr(data, key, value[perm])
    data.edge_index = inv[data.edge_index]
    return data


def window_density(senders, receivers, num_nodes: int,
                   window: int = 256) -> Tuple[int, float]:
    """``(non-empty buckets, mean edges per non-empty bucket)`` of the
    (window x window) tiling of the adjacency: how well a node order
    gathers the edges into few blocks."""
    sw = np.asarray(senders) // window
    dw = np.asarray(receivers) // window
    nw = -(-num_nodes // window)
    _, counts = np.unique(dw * nw + sw, return_counts=True)
    return len(counts), float(counts.mean())
