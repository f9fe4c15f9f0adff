"""Graph-level prediction models: a readout head over the conv zoo.

Counterpart of ``pytorch_geometric_tpu/models/graph_pred.py`` (the
reference's graph-classification examples: GIN on MUTAG,
examples/mutag_gin.py:25-59; TopK on ENZYMES,
examples/enzymes_topk_pool.py:24-48): conv stack -> global readout ->
linear head. The logits include the padding graph's row;
:func:`graph_xent_loss` masks it out by ``graph_mask``.

On a card the GCN layers aggregate through ``aggregate_fn`` (an
``SpmmOperator.bind`` of the batch's ``gcn_edge_set``,
``models/citation.py:gcn_spmm_operator``) and the mean readout through
``segment_op`` (``nn/pool/global_pool.py:pool_operator``), both built on
the host once per batch.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.models.citation import (
    softmax_xent_int_labels)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import GCNConv, gcn_norm
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.pool.global_pool import global_mean_pool


class GraphClassifier(nn.Module):
    """GCN stack (``conv1`` ..) + mean readout + linear head
    (``Dense_0``, flax's auto-name)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_classes: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_classes = num_classes
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"conv{i + 1}", GCNConv(
                in_channels if i == 0 else hidden_channels, hidden_channels,
                generator=generator))
        self.Dense_0 = Dense(hidden_channels, num_classes,
                             generator=generator)

    def forward(self, graph: Graph, x=None, *, train: bool = False,
                aggregate_fn=None, segment_op=None):
        x = graph.x if x is None else x
        norm = gcn_norm(graph) if aggregate_fn is None else None
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i + 1}")(graph, x, norm=norm,
                                              aggregate_fn=aggregate_fn)
            x = torch.relu(x)
        g = global_mean_pool(x, graph, segment_op=segment_op)
        return self.Dense_0(g)              # logits incl. pad graph


def graph_xent_loss(logits, y, graph_mask):
    """Mean cross-entropy over the graphs of ``graph_mask``."""
    nll = softmax_xent_int_labels(logits, y)
    m = graph_mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
