"""Self loops (counterpart of ``pytorch_geometric_tpu/utils/loop.py``):
``add_self_loops`` appends one loop per node, padding nodes included, so
the edge count grows by exactly N (E -> E + N)."""

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
