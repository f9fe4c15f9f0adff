"""Self loops (counterpart of ``pytorch_geometric_tpu/utils/loop.py``):
``add_self_loops`` appends one loop per node, padding nodes included, so
the edge count grows by exactly N (E -> E + N); ``remove_self_loops``
compacts them away (the edge count shrinks, so it is a loader-time
edit); ``self_loop_mask`` marks the other edges and keeps the shape."""

import torch


def add_self_loops(senders, receivers, num_nodes: int, edge_weight=None,
                   fill_value: float = 1.0):
    """Append one self loop per node (E -> E + N)."""
    loop = torch.arange(num_nodes, dtype=senders.dtype,
                        device=senders.device)
    senders = torch.cat([senders, loop])
    receivers = torch.cat([receivers, loop])
    if edge_weight is not None:
        fill = torch.full((num_nodes,), fill_value, dtype=edge_weight.dtype,
                          device=edge_weight.device)
        edge_weight = torch.cat([edge_weight, fill])
    return senders, receivers, edge_weight


def remove_self_loops(senders, receivers, edge_attr=None):
    """Drop the edges whose sender is their receiver (and their rows of
    ``edge_attr``): a compacting edit, whose output size depends on the
    data."""
    keep = senders != receivers
    ea = None if edge_attr is None else edge_attr[keep]
    return senders[keep], receivers[keep], ea


def self_loop_mask(senders, receivers):
    """Boolean mask of the edges that are not self loops (shape kept)."""
    return senders != receivers


def contains_self_loops(senders, receivers) -> bool:
    return bool((senders == receivers).any())
