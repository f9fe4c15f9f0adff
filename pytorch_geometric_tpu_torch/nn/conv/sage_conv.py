"""GraphSAGE convolutions, sparse and dense.

Counterpart of ``pytorch_geometric_tpu/nn/conv/sage_conv.py`` (reference:
``torch_geometric.nn.SAGEConv`` and ``DenseSAGEConv``, PyG 1.4.x):
x' = W . mean_{j in N(i) and i} x_j (+ b), optional L2 normalisation.

``SAGEConv``'s neighbour sum is :func:`propagate`'s identity message over
the real edges (pass the graph's operators, ``propagate_operators``, for
the ``spmm_csr`` kernel), or ``aggregate_fn(x)``, any operator that sums
the real edges' sender rows into their receivers (examples/reddit_sage.py:
one ``spmm_csr`` over a sampled batch's real edges); the same operator
over a column of ones then gives the masked in-degree, so no segment op
runs beside it. Adding x_i and dividing by deg_i + 1 makes the
self-inclusive mean. On an edge partition (``shard_ctx``, parallel/
api.py) the partition's mean weighting carries 1 / (deg + 1) over the
self-loop-augmented edges, so its one aggregation is that mean.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import propagate
from pytorch_geometric_tpu_torch.utils.degree import degree


def _l2_normalize(out):
    # rsqrt form: a zero row gives a zero output with a finite gradient
    return out * torch.rsqrt((out * out).sum(-1, keepdim=True) + 1e-12)


class SAGEConv(nn.Module):
    """``weight`` (in, out), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalize: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.weight = nn.Parameter(glorot((in_channels, out_channels),
                                          generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, spmm_op=None, segment_op=None,
                aggregate_fn=None, shard_ctx=None):
        if shard_ctx is not None:
            out = shard_ctx.aggregate("mean", x) @ self.weight
            if self.bias is not None:
                out = out + self.bias
            return _l2_normalize(out) if self.normalize else out
        if aggregate_fn is not None:
            s = aggregate_fn(x)
            deg = aggregate_fn(x.new_ones((x.shape[0], 1)))[:, 0]
        else:
            ew = graph.real_edge_mask().to(x.dtype)
            s = propagate(graph, x, aggr="add", edge_weight=ew,
                          spmm_op=spmm_op, segment_op=segment_op)
            deg = degree(graph.receivers, graph.num_nodes, dtype=x.dtype,
                         mask=graph.edge_mask)
        out = ((s + x) / (deg + 1.0)[:, None]) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return _l2_normalize(out) if self.normalize else out


class DenseSAGEConv(nn.Module):
    """Dense-adjacency SAGE (DiffPool blocks): x (B, N, F) or (N, F), adj
    (B, N, N), optional mask (B, N)."""

    def __init__(self, in_channels: int, out_channels: int,
                 normalize: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.weight = nn.Parameter(glorot((in_channels, out_channels),
                                          generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, x, adj, mask=None):
        if x.ndim == 2:
            x, adj = x[None], adj[None]
        n = x.shape[1]
        a = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)[None]
        s = torch.einsum("bij,bjf->bif", a, x)
        mean = s / a.sum(-1, keepdim=True).clamp_min(1.0)
        out = torch.einsum("bif,fo->bio", mean, self.weight)
        if self.bias is not None:
            out = out + self.bias
        if self.normalize:
            out = _l2_normalize(out)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out
