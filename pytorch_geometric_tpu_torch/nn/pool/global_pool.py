"""Global graph readouts (reference: ``global_add_pool``,
``global_mean_pool``, ``global_max_pool``; examples/mutag_gin.py:8,59,
examples/enzymes_topk_pool.py:8,40-48).

Counterpart of ``pytorch_geometric_tpu/nn/pool/global_pool.py``: segment
reductions of the node rows by the ``batch`` vector into one row per
graph, the padding graph's (the last id) included. Every row equals the
JAX function's:

- add: the rows outside ``node_mask`` are zeroed, then summed by
  ``batch``;
- mean and max: a node outside ``node_mask`` counts for the padding
  graph (id ``g - 1``) with its own x, not zeroed, as the JAX functions
  route it.

Where the sums run. A collated batch is sorted by graph id and its
padding nodes sit on the last one, so the sums go through one
``SortedSegmentSum`` over ``batch`` (:func:`pool_operator`, built on the
host once per batch beside ``propagate_operators``) and the segment-sum
kernel on a card. After ``TopKPooling`` the mask is a device tensor and no
longer matches the operator's rows, so the mean sums the masked rows and
their count by ``batch`` in one call of the operator, then adds the
dropped nodes' sum and count to the last row: the JAX routing, exactly,
with one reduction more. Without the operator, on the CPU only, the JAX
functions' plain segment ops; on a CUDA tensor a sum or mean without it
raises. The max is torch's ``scatter_reduce`` (neither package has a
segment-max kernel).
"""

from typing import Optional

import torch

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.segment import (
    segment_max, segment_mean, segment_sum)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum


def _batch_of(graph, batch):
    if batch is not None:
        return batch
    if graph.batch is not None:
        return graph.batch
    return torch.zeros((graph.num_nodes,), dtype=torch.int32,
                       device=graph.device)


def _num_graphs(graph, b, num_graphs):
    return num_graphs or (graph.num_graphs if graph is not None
                          else int(b.max()) + 1)


def pool_operator(graph: Graph, device=None) -> SortedSegmentSum:
    """The ``SortedSegmentSum`` of the readouts over ``graph``'s batch
    vector into its ``num_graphs`` rows (the padding graph's included),
    the nodes outside ``node_mask`` routed to the padding graph as the
    JAX mean and max route them (a collated batch's padding nodes are
    there already; a pooled level's unoccupied rows are not), on
    ``device`` (default: the graph's). Built on the host."""
    b = _batch_of(graph, None)
    if graph.node_mask is not None:
        b = torch.where(graph.node_mask, b, graph.num_graphs - 1)
    return SortedSegmentSum(b, graph.num_graphs,
                            device=graph.device if device is None
                            else device)


def _segment_sum(x, b, g, segment_op, what):
    if segment_op is None:
        require_cpu(x, what, "segment_op (pool_operator)")
        return segment_sum(x, b, g)
    if segment_op.num_nodes != g:
        raise ValueError(f"{what}: segment_op has {segment_op.num_nodes} "
                         f"rows, expected {g} graphs")
    return segment_op(x)


def global_add_pool(x, graph: Optional[Graph] = None, batch=None,
                    num_graphs: Optional[int] = None,
                    segment_op: Optional[SortedSegmentSum] = None):
    """Sum of each graph's real node rows, (num_graphs, F)."""
    b = _batch_of(graph, batch)
    g = _num_graphs(graph, b, num_graphs)
    if graph is not None and graph.node_mask is not None:
        x = torch.where(graph.node_mask.reshape(
            (-1,) + (1,) * (x.ndim - 1)), x, 0.0)
    return _segment_sum(x, b, g, segment_op, "global_add_pool")


def global_mean_pool(x, graph: Optional[Graph] = None, batch=None,
                     num_graphs: Optional[int] = None,
                     segment_op: Optional[SortedSegmentSum] = None):
    """Mean of each graph's node rows, (num_graphs, F); nodes outside the
    mask count for the padding graph, the last row."""
    b = _batch_of(graph, batch)
    g = _num_graphs(graph, b, num_graphs)
    mask = graph.node_mask if graph is not None else None
    if segment_op is None:
        require_cpu(x, "global_mean_pool", "segment_op (pool_operator)")
        if mask is not None:
            # route padded nodes to the padding graph id so counts stay
            # exact
            b = torch.where(mask, b, g - 1)
        return segment_mean(x, b, g)
    flat = x.reshape(x.shape[0], -1)
    ones = flat.new_ones((flat.shape[0], 1))
    if mask is None:
        sums = _segment_sum(torch.cat([flat, ones], 1), b, g, segment_op,
                            "global_mean_pool")
    else:
        m = mask.to(flat.dtype)[:, None]
        sums = _segment_sum(torch.cat([flat * m, m], 1), b, g, segment_op,
                            "global_mean_pool")
        dropped = torch.cat([flat * (1.0 - m), 1.0 - m], 1).sum(0)
        sums = torch.cat([sums[:-1], sums[-1:] + dropped], 0)
    out = sums[:, :-1] / sums[:, -1:].clamp_min(1.0)
    return out.reshape((g,) + tuple(x.shape[1:]))


def global_max_pool(x, graph: Optional[Graph] = None, batch=None,
                    num_graphs: Optional[int] = None):
    """Max of each graph's node rows, (num_graphs, F); empty rows 0;
    nodes outside the mask count for the padding graph."""
    b = _batch_of(graph, batch)
    g = _num_graphs(graph, b, num_graphs)
    if graph is not None and graph.node_mask is not None:
        b = torch.where(graph.node_mask, b, g - 1)
    return segment_max(x, b, g)
