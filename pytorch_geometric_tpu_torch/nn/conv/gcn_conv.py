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
- The closure path (``closure=``, a ``data/closure.py:ClosureLayer``, with
  ``norm`` the layer's ``(w_edge, w_self)`` of :func:`gcn_closure_norm`):
  the message sum over the layer's edges into its ``n_out`` rows, then
  the self term ``w_self * h[self_idx]``, as the JAX module. The sum runs
  through ``aggregate_fn``, the layer's rectangular operator
  (:func:`gcn_closure_operator`: one ``spmm_csr`` a direction); without
  it, plain segment ops, on a CPU tensor only.
- ``weight`` is (in, out) as in the JAX module, so ``h = x @ weight``.
"""

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import (
    pack_bipartite_tables, spmm, spmm_bi_static)
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


def gcn_edge_set(graph: Graph):
    """``(senders, receivers, weights)`` of the GCN aggregation: the
    self-looped ``gcn_norm`` edge set with the padding edges left out.
    They weigh 0, so no sum changes; kept, they would all land in the
    padding node's CSR row, and a row-parallel kernel's time follows its
    longest row. Every self loop stays, padding nodes' included."""
    norm = gcn_norm(graph)
    keep = torch.cat([graph.real_edge_mask(),
                      torch.ones(graph.num_nodes, dtype=torch.bool,
                                 device=graph.device)])
    return norm.senders[keep], norm.receivers[keep], norm.weights[keep]


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


def gcn_closure_norm(edge_index, num_nodes: int, layers,
                     improved: bool = False):
    """Per-layer ``(w_edge, w_self)`` of the closure path, fp32 tensors
    on the layers' device: ``w_edge`` per closure edge (0 on padding
    edges), ``w_self`` per output row (0 past the real ones).

    Degrees come from the full graph's ``edge_index`` (host, its real
    edges): a closure keeps all in-edges of the needed receivers only, so
    the senders' degrees cannot be recovered from it. Host float64, then
    fp32, as the JAX function; static."""
    fill = 2.0 if improved else 1.0
    ei = np.asarray(edge_index.cpu() if isinstance(edge_index, torch.Tensor)
                    else edge_index)
    deg = np.bincount(ei[1], minlength=num_nodes).astype(np.float64)
    deg = deg + fill
    dis = deg ** -0.5
    norms = []
    for cl in layers:
        sg = cl.sender_global.cpu().numpy()
        og = cl.out_global.cpu().numpy()
        rg = og[cl.receivers.cpu().numpy()]
        m = cl.edge_mask.cpu().numpy()
        w_edge = np.where(m, dis[sg] * dis[rg], 0.0)
        w_self = fill / deg[og]
        w_self[cl.num_real_out:] = 0.0
        dev = cl.senders.device
        norms.append((torch.from_numpy(w_edge.astype(np.float32)).to(dev),
                      torch.from_numpy(w_self.astype(np.float32)).to(dev)))
    return norms


def gcn_closure_operator(closure, w_edge):
    """The message sum of one closure layer, ``h (n_in, F) -> (n_out,
    F)``, weighted by ``w_edge``: an fp32 rectangular SpMM over the
    layer's real edges (its padding edges weigh 0 and are left out, as
    ``gcn_edge_set`` leaves out a graph's), one ``spmm_csr`` forward and
    one over the transposed CSR for ``dh``. Built on the host once, on
    the layer's device; pass it as ``GCNConv``'s ``aggregate_fn``."""
    e = closure.num_real_edges
    geom, consts = pack_bipartite_tables(
        closure.senders[:e], closure.receivers[:e], closure.n_in,
        closure.n_out, w_edge[:e], compute_dtype=torch.float32,
        device=closure.senders.device)
    return functools.partial(spmm_bi_static, geom, consts)


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
                norm_dense=None, aggregate_fn=None, closure=None,
                shard_ctx=None):
        h = x @ self.weight
        if shard_ctx is not None:
            # the edge partition (parallel/api.py): x is this rank's (S, F)
            # shard; the partition's GCN weighting holds the self loops
            # and the symmetric normalisation of gcn_norm
            out = shard_ctx.aggregate("gcn", h)
        elif closure is not None:
            # weights from full-graph degrees: the result is the full
            # conv's at the closure's output nodes
            w_edge, w_self = norm
            if aggregate_fn is not None:
                out = aggregate_fn(h)
            else:
                require_cpu(h, "GCNConv(closure=)", "aggregate_fn="
                            "gcn_closure_operator(closure, w_edge)")
                msgs = h[closure.senders.long()] * w_edge[:, None]
                out = segment_sum(msgs, closure.receivers, closure.n_out)
            out = out + w_self[:, None] * h[closure.self_idx.long()]
        elif aggregate_fn is not None:
            # fully custom aggregation (e.g. a bound SpmmOperator with the
            # static normalised weights baked in)
            out = aggregate_fn(h)
        elif norm_dense is not None:
            # operands in the adjacency's type, products and sums in fp32,
            # fp32 out: the JAX preferred_element_type=float32 (a product
            # of two bf16 values is exact in fp32)
            out = norm_dense.float() @ h.to(norm_dense.dtype).float()
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
