"""EdgeConv (Wang et al., DGCNN).

Counterpart of ``pytorch_geometric_tpu/nn/conv/edge_conv.py`` (reference
README's MessagePassing tutorial): message = mlp([x_i, x_j - x_i]), max
aggregation by default, through :func:`propagate` (``max`` / ``min`` are
torch's ``scatter_reduce``; a sum or mean takes ``segment_op``).
"""

from typing import Callable

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.message_passing import propagate


class EdgeConv(nn.Module):
    """``mlp``: a module (E, 2F) -> (E, C)."""

    def __init__(self, mlp: Callable, aggr: str = "max"):
        super().__init__()
        self.mlp, self.aggr = mlp, aggr

    def forward(self, graph: Graph, x, segment_op=None):
        def message(x_j, x_i, _):
            return self.mlp(torch.cat([x_i, x_j - x_i], dim=-1))

        return propagate(graph, x, message_fn=message, aggr=self.aggr,
                         segment_op=segment_op)
