"""k-hop subgraph extraction, on the host in numpy.

Counterpart of ``pytorch_geometric_tpu/utils/k_hop_subgraph.py``
(reference: ``torch_geometric.utils.k_hop_subgraph``, the same signature
and return contract). Subgraph extraction is index bookkeeping at
data-preparation time, so it stays on the host, as in the JAX package.
"""

from typing import Tuple

import numpy as np


def k_hop_subgraph(node_idx, num_hops: int, edge_index,
                   relabel_nodes: bool = False,
                   num_nodes: int = None,
                   flow: str = "source_to_target") -> Tuple:
    """Nodes/edges reachable within ``num_hops`` of ``node_idx``.

    Returns ``(subset, edge_index, mapping, edge_mask)``:
    - subset: node indices of the subgraph (seeds first, then newly
      reached nodes in hop order);
    - edge_index: the (relabelled if requested) edges of the subgraph;
    - mapping: positions of the seed nodes inside ``subset``;
    - edge_mask: boolean mask over the original edges.
    """
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    if flow == "source_to_target":
        row, col = edge_index[0], edge_index[1]
    elif flow == "target_to_source":
        row, col = edge_index[1], edge_index[0]
    else:
        raise ValueError(f"unknown flow {flow!r}")

    node_idx = np.atleast_1d(np.asarray(node_idx)).astype(np.int64)
    node_mask = np.zeros(num_nodes, dtype=bool)

    subsets = [node_idx]
    node_mask[node_idx] = True
    for _ in range(num_hops):
        hop_edges = node_mask[col]          # edges whose target reached
        new = row[hop_edges]
        new = new[~node_mask[new]]
        new = np.unique(new)
        subsets.append(new)
        node_mask[new] = True

    subset = np.concatenate(subsets)
    edge_mask = node_mask[row] & node_mask[col]
    sub_edges = edge_index[:, edge_mask]

    if relabel_nodes:
        remap = np.full(num_nodes, -1, dtype=np.int64)
        remap[subset] = np.arange(subset.shape[0])
        sub_edges = remap[sub_edges]
        mapping = remap[node_idx]
    else:
        pos = {int(n): i for i, n in enumerate(subset)}
        mapping = np.array([pos[int(n)] for n in node_idx],
                           dtype=np.int64)
    return subset, sub_edges, mapping, edge_mask
