"""Sparse <-> dense conversions, in torch.

Counterpart of ``pytorch_geometric_tpu/utils/convert.py`` (reference:
the ``ToDense`` transform and ``dense_diff_pool``'s input format,
examples/enzymes_diff_pool.py). The shape arguments are host ints; where
they are left out, they are read from the index tensors (one wait on the
card).
"""

import torch


def _local_positions(batch):
    """Position of each node within its graph, counted in node order
    (``batch`` groups nodes by graph, as the collation lays them out)."""
    batch = batch.long()
    n = batch.shape[0]
    order = torch.argsort(batch, stable=True)
    inv = torch.argsort(order, stable=True)
    sorted_batch = batch[order].contiguous()
    idx = torch.arange(n, device=batch.device) - torch.searchsorted(
        sorted_batch, sorted_batch, side="left")
    return idx[inv]


def to_dense_adj(senders, receivers, batch=None, edge_weight=None,
                 num_nodes=None, max_num_nodes=None, edge_mask=None,
                 num_graphs=None):
    """Dense adjacency, ``adj[sender, receiver]`` summed over edges.
    One graph: (N, N). Batched: (G, M, M) over each graph's local node
    positions; edges with an end at or past ``max_num_nodes`` are left
    out, and padding edges must be masked (``edge_mask``)."""
    senders, receivers = senders.long(), receivers.long()
    if batch is None and num_nodes is None:
        num_nodes = (int(torch.maximum(senders, receivers).max()) + 1
                     if senders.numel() else 0)
    if edge_weight is None:
        edge_weight = torch.ones(senders.shape, dtype=torch.float32,
                                 device=senders.device)
    if edge_mask is not None:
        edge_weight = torch.where(edge_mask, edge_weight, 0.0)
    if batch is None:
        adj = torch.zeros((num_nodes, num_nodes), dtype=edge_weight.dtype,
                          device=senders.device)
        return adj.index_put_((senders, receivers), edge_weight,
                              accumulate=True)
    batch = batch.long()
    if num_graphs is None:
        num_graphs = int(batch.max()) + 1
    pos = _local_positions(batch)
    m = max_num_nodes if max_num_nodes is not None \
        else int(pos.max()) + 1
    g = batch[receivers]
    pr, ps = pos[receivers], pos[senders]
    w = torch.where((pr < m) & (ps < m), edge_weight, 0.0)
    adj = torch.zeros((num_graphs, m, m), dtype=edge_weight.dtype,
                      device=senders.device)
    return adj.index_put_((g, ps.clamp_max(m - 1), pr.clamp_max(m - 1)), w,
                          accumulate=True)


def to_dense_batch(x, batch, num_graphs, max_num_nodes, node_mask=None):
    """Node features scattered into (G, M, F) and the (G, M) mask of the
    slots filled. Nodes at or past ``max_num_nodes`` in their graph, and
    nodes outside ``node_mask``, are left out: they go to a spare slot M
    that is cut off, so every kept slot is written once."""
    batch = batch.long()
    pos = _local_positions(batch)
    valid = pos < max_num_nodes
    if node_mask is not None:
        valid = valid & node_mask
    slot = torch.where(valid, pos, max_num_nodes)
    out = torch.zeros((num_graphs, max_num_nodes + 1) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    out[batch, slot] = x
    mask = torch.zeros((num_graphs, max_num_nodes + 1), dtype=torch.bool,
                       device=x.device)
    mask[batch, slot] = valid
    return out[:, :max_num_nodes], mask[:, :max_num_nodes]
