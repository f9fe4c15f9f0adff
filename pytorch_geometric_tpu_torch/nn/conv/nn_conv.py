"""Edge-conditioned convolution (NNConv / ECC; Gilmer, Simonovsky).

Counterpart of ``pytorch_geometric_tpu/nn/conv/nn_conv.py`` (reference:
``torch_geometric.nn.NNConv``): x'_i = x_i W_root + aggr_j x_j Θ(e_ij),
where ``edge_nn`` maps each edge's attributes to an (F_in, F_out) matrix.

The messages are built per edge (an einsum over the edges) and summed by
:func:`propagate`'s message path: pass ``segment_op`` (the graph's
``SortedSegmentSum``, ``propagate_operators``) for the
``sorted_segment_sum`` kernel.
"""

from typing import Callable, Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import propagate


class NNConv(nn.Module):
    """``edge_nn``: a module (E, Fe) -> (E, F_in * out_channels);
    ``root`` (F_in, out), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int,
                 edge_nn: Callable, aggr: str = "add",
                 root_weight: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.edge_nn, self.aggr = edge_nn, aggr
        self.root = nn.Parameter(glorot((in_channels, out_channels),
                                        generator)) if root_weight else None
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, edge_attr=None, segment_op=None):
        ea = edge_attr if edge_attr is not None else graph.edge_attr
        theta = self.edge_nn(ea).reshape(-1, self.in_channels,
                                         self.out_channels)

        def message(x_j, x_i, _):
            return torch.einsum("ef,efc->ec", x_j, theta)

        out = propagate(graph, x, message_fn=message, aggr=self.aggr,
                        edge_weight=None if self.aggr != "add" else
                        graph.real_edge_mask().to(x.dtype),
                        segment_op=segment_op)
        if self.root is not None:
            out = out + x @ self.root
        return out + self.bias if self.bias is not None else out
