"""GIN convolution (Xu et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/gin_conv.py`` (reference:
``torch_geometric.nn.GINConv``): x' = MLP((1 + eps) x + sum_j x_j); eps
is trained iff ``train_eps``. The sum is :func:`propagate`'s identity
message over the real edges: pass the graph's operators
(``propagate_operators``) for the ``spmm_csr`` kernel.
"""

from typing import Callable

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.message_passing import propagate


class GINConv(nn.Module):
    """``mlp``: any module applied to the aggregated features; ``eps`` a
    scalar parameter when ``train_eps``."""

    def __init__(self, mlp: Callable, eps: float = 0.0,
                 train_eps: bool = False):
        super().__init__()
        self.mlp = mlp
        self.eps = nn.Parameter(torch.tensor(float(eps))) if train_eps \
            else float(eps)

    def forward(self, graph: Graph, x, *, train: bool = False,
                spmm_op=None, segment_op=None):
        agg = propagate(graph, x, aggr="add",
                        edge_weight=graph.real_edge_mask().to(x.dtype),
                        spmm_op=spmm_op, segment_op=segment_op)
        out = (1.0 + self.eps) * x + agg
        # The wrapped MLP may take the node mask (padding-aware batch norm)
        # and a train flag; plain modules take neither (as in the JAX
        # module)
        for kwargs in ({"mask": graph.node_mask, "train": train},
                       {"train": train}, {}):
            try:
                return self.mlp(out, **kwargs)
            except TypeError:
                continue
        return self.mlp(out)
