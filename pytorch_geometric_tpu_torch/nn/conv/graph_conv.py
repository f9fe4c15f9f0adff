"""GraphConv, the Weisfeiler-Leman conv (Morris et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/graph_conv.py``
(reference: ``torch_geometric.nn.GraphConv``):
x' = x W_root + aggr_j(x_j) W_nbr + b, ``aggr`` default add. The
aggregation is :func:`propagate`'s identity message: pass the graph's
operators (``propagate_operators``) for the ``spmm_csr`` kernel.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import propagate


class GraphConv(nn.Module):
    """``weight_root``, ``weight_nbr`` (in, out), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggr: str = "add", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        self.weight_root = nn.Parameter(glorot((in_channels, out_channels),
                                               generator))
        self.weight_nbr = nn.Parameter(glorot((in_channels, out_channels),
                                              generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, edge_weight=None, spmm_op=None,
                segment_op=None):
        if edge_weight is None and graph.edge_mask is not None and \
                self.aggr in ("add", "sum"):
            edge_weight = graph.edge_mask.to(x.dtype)
        agg = propagate(graph, x, aggr=self.aggr, edge_weight=edge_weight,
                        spmm_op=spmm_op, segment_op=segment_op)
        out = x @ self.weight_root + agg @ self.weight_nbr
        return out + self.bias if self.bias is not None else out
