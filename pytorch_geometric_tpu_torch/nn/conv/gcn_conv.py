"""GCN convolution (Kipf & Welling).

Counterpart of ``pytorch_geometric_tpu/nn/conv/gcn_conv.py`` (reference:
``torch_geometric.nn.GCNConv`` with ``cached=True``). Semantics:
x' = D^-1/2 (A + fI) D^-1/2 x W + b with f = 2 if improved else 1.

- The normalised adjacency depends only on the static graph, so it is
  computed once (:func:`gcn_norm`) and passed back in as an
  :class:`EdgeNorm`.
- Aggregation paths, as in the JAX module: the plain sparse path
  (``ops/spmm.py:spmm``), a dense normalised adjacency (``norm_dense``),
  an ``SpmmOperator`` called with the norm weights (``spmm_op``), or any
  ``aggregate_fn(h)`` such as ``SpmmOperator.bind(norm.weights)``.
- ``weight`` is (in, out) as in the JAX module, so ``h = x @ weight``.
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import spmm
from pytorch_geometric_tpu_torch.utils.loop import add_self_loops


@dataclasses.dataclass(frozen=True)
class EdgeNorm:
    """Cached normalised edge set (self loops appended)."""
    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor


def gcn_norm(graph: Graph, edge_weight=None, improved: bool = False,
             dtype=torch.float32) -> EdgeNorm:
    """Symmetric normalisation with self loops.

    Padding edges get weight 0 through ``real_edge_mask``; every node,
    padding nodes included, gets a self loop of weight ``fill``, so a
    padding node's degree is ``fill``."""
    N = graph.num_nodes
    fill = 2.0 if improved else 1.0
    if edge_weight is None:
        edge_weight = graph.real_edge_mask().to(dtype)
    senders, receivers, w = add_self_loops(
        graph.senders, graph.receivers, N, edge_weight, fill_value=fill)
    deg = segment_sum(w, receivers, N)
    dis = torch.where(deg > 0, deg.clamp_min(1e-12) ** -0.5, 0.0)
    norm = dis[senders.long()] * w * dis[receivers.long()]
    return EdgeNorm(senders=senders, receivers=receivers, weights=norm)


def gcn_norm_dense(graph: Graph, edge_weight=None, improved: bool = False,
                   dtype=torch.float32):
    """Dense normalised adjacency (N, N), ``adj[receiver, sender]``, for
    small padded graphs (memory N^2 * dtype)."""
    norm = gcn_norm(graph, edge_weight, improved, torch.float32)
    n = graph.num_nodes
    adj = torch.zeros((n, n), dtype=torch.float32, device=graph.device)
    adj.index_put_((norm.receivers.long(), norm.senders.long()),
                   norm.weights, accumulate=True)
    return adj.to(dtype)


class GCNConv(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.improved = improved
        self.weight = nn.Parameter(glorot((in_channels, out_channels),
                                          generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, edge_weight=None,
                norm: Optional[EdgeNorm] = None, spmm_op=None,
                norm_dense=None, aggregate_fn=None):
        h = x @ self.weight
        if aggregate_fn is not None:
            # fully custom aggregation (e.g. a bound SpmmOperator with the
            # static normalised weights baked in)
            out = aggregate_fn(h)
        elif norm_dense is not None:
            out = (norm_dense @ h.to(norm_dense.dtype)).float()
        elif spmm_op is not None:
            if norm is None:
                norm = gcn_norm(graph, edge_weight, self.improved, h.dtype)
            out = spmm_op(norm.weights, h)
        else:
            if norm is None:
                norm = gcn_norm(graph, edge_weight, self.improved, h.dtype)
            out = spmm(norm.senders, norm.receivers, h, graph.num_nodes,
                       weights=norm.weights)
        if self.bias is not None:
            out = out + self.bias
        return out
