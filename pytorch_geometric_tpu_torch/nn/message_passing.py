"""The message-passing core: gather -> edge map -> segment reduce.

Counterpart of ``pytorch_geometric_tpu/nn/message_passing.py``: convs call
the pure function :func:`propagate` with an explicit ``message_fn``
closure (reference: ``MessagePassing.propagate``, which gathers
``x_j = x[edge_index[0]]``, applies ``message`` and scatter-reduces by
``edge_index[1]``).

Where the sum of the feature rows runs:

- identity message, ``add`` / ``sum`` (or ``mean``), with ``spmm_op``
  (an ``SpmmOperator`` over the graph's edges): the weighted SpMM, the
  JAX package's fast path; on a CUDA tensor the ``spmm_csr`` kernel;
- any message, ``add`` / ``sum`` (or ``mean``), with ``segment_op`` (a
  ``SortedSegmentSum`` over the graph's receivers): the messages are
  built in edge order and summed by the segment-sum kernel;
- ``mean`` divides either sum by the real in-degree, a sum of E scalars;
- ``max`` / ``min``: torch's ``scatter_reduce`` with the JAX fill and mask
  (neither package has a kernel for them).

The operators are built on the host once per graph
(:func:`propagate_operators`) and passed in: nothing builds a CSR inside
a training step. On the CPU, without operators, the sums run as plain
segment ops, the same function as the JAX slow path; on a CUDA tensor a
sum or mean without its operator raises, so no feature rows are summed
there by plain segment ops.
"""

from typing import Callable, Optional

import torch

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.debug import is_debug_enabled
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.segment import scatter, segment_sum
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

AGGRS = ("add", "sum", "mean", "max", "min")


def propagate_operators(graph: Graph):
    """``{"spmm_op", "segment_op"}`` of ``graph`` on its device, for
    :func:`propagate` (and the convs that pass them on): an
    ``SpmmOperator`` over all of its edges and a ``SortedSegmentSum`` over
    its receivers, padding edges included, so that weights and messages
    go in in edge order. Built on the host."""
    n = graph.num_nodes
    return {"spmm_op": SpmmOperator(graph.senders, graph.receivers, n,
                                    device=graph.device),
            "segment_op": SortedSegmentSum(graph.receivers, n,
                                           device=graph.device)}


def require_cpu(x, what: str, operators: str):
    """Raise unless ``x`` is on the CPU: ``what`` sums feature rows by
    plain segment ops only there; elsewhere it needs ``operators``."""
    if x.device.type != "cpu":
        raise ValueError(f"{what} on a {x.device.type} tensor needs "
                         f"{operators}: feature rows are not summed by "
                         "plain segment ops off the CPU")


def _check_edges(graph: Graph, x, num_nodes):
    """Debug-mode validation on the host (the JAX package's, skipped for
    tracers; here skipped while a CUDA graph is captured, because reading
    the card would break the capture)."""
    s, r = host_array(graph.senders), host_array(graph.receivers)
    if s.shape != r.shape:
        raise ValueError("senders/receivers shape mismatch: "
                         f"{s.shape} vs {r.shape}")
    if s.size and (s.min() < 0 or s.max() >= num_nodes or
                   r.min() < 0 or r.max() >= num_nodes):
        raise ValueError(f"edge indices out of range [0, {num_nodes})")
    if x is not None and x.shape[0] != num_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, expected {num_nodes}")


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _expand(v, ndim):
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def propagate(graph: Graph, x, message_fn: Optional[Callable] = None,
              aggr: str = "add", edge_weight=None, x_dst=None,
              spmm_op: Optional[SpmmOperator] = None,
              segment_op: Optional[SortedSegmentSum] = None,
              sender_op: Optional[SortedSegmentSum] = None):
    """One message-passing round over ``graph``.

    ``x`` (N, ...) source features; ``message_fn(x_j, x_i, edge_attr)``
    (default: identity on ``x_j``); ``aggr`` one of :data:`AGGRS`;
    ``edge_weight`` (E,) multiplies the messages; ``x_dst`` gives ``x_i``
    for bipartite message functions; ``spmm_op`` / ``segment_op`` are the
    graph's operators (:func:`propagate_operators`), which the sums run
    through (see the module docstring). ``sender_op``, a
    ``SortedSegmentSum`` over the senders, gathers ``x_j`` (its
    ``gather``): the gradient of ``x`` then sums by sender in the
    segment-sum kernel, in a fixed order, where torch's gather backward
    adds with atomics in an order that varies from run to run. Padding
    edges point at a padding node, so sums need no mask; ``mean``,
    ``max`` and ``min`` leave them out through ``graph.edge_mask``."""
    if aggr not in AGGRS:
        raise ValueError(f"aggr must be one of {AGGRS}, got {aggr!r}")
    num_nodes = graph.num_nodes
    if is_debug_enabled() and not _capturing():
        _check_edges(graph, x, num_nodes)
    masked = aggr in ("mean", "max", "min") and graph.edge_mask is not None

    if aggr in ("add", "sum", "mean"):
        if message_fn is None and spmm_op is not None:
            w = edge_weight if edge_weight is not None else \
                graph.real_edge_mask().to(x.dtype)
            if masked:
                w = torch.where(graph.edge_mask, w, 0.0)
            out = _rows(spmm_op, w, x)
        else:
            if segment_op is None:
                require_cpu(x, f"propagate(aggr={aggr!r})",
                            "spmm_op for the identity message, segment_op "
                            "for a message_fn (propagate_operators)")
            msg = _messages(graph, x, message_fn, edge_weight, x_dst,
                            sender_op)
            if masked:
                msg = torch.where(_expand(graph.edge_mask, msg.ndim), msg,
                                  0.0)
            out = _rows(segment_op, msg) if segment_op is not None else \
                segment_sum(msg, graph.receivers, num_nodes)
        if aggr != "mean":
            return out
        cnt = segment_sum(graph.real_edge_mask().to(out.dtype),
                          graph.receivers, num_nodes).clamp_min(1.0)
        return out / _expand(cnt, out.ndim)

    msg = _messages(graph, x, message_fn, edge_weight, x_dst, sender_op)
    if not masked:
        return scatter(msg, graph.receivers, num_nodes, reduce=aggr)
    big = torch.finfo(msg.dtype).max
    msg = torch.where(_expand(graph.edge_mask, msg.ndim), msg,
                      -big if aggr == "max" else big)
    out = scatter(msg, graph.receivers, num_nodes, reduce=aggr)
    return torch.where(out.abs() >= big, 0.0, out)


def _rows(op, *args):
    """``op`` on the last argument as (rows, features), the operators'
    layout, and its result back in that argument's trailing shape."""
    *rest, t = args
    out = op(*rest, t.reshape(t.shape[0], -1))
    return out.reshape(out.shape[:1] + t.shape[1:])


def _messages(graph: Graph, x, message_fn, edge_weight, x_dst,
              sender_op=None):
    """The per-edge messages in edge order, weighted."""
    x_j = sender_op.gather(x) if sender_op is not None else \
        x.index_select(0, graph.senders.long())
    if message_fn is not None:
        x_i = (x_dst if x_dst is not None else x).index_select(
            0, graph.receivers.long())
        msg = message_fn(x_j, x_i, graph.edge_attr)
    else:
        msg = x_j
    if edge_weight is not None:
        msg = msg * _expand(edge_weight, msg.ndim)
    return msg

