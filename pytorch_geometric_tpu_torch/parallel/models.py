"""Distributed two-layer models built from the public conv zoo.

Counterpart of ``pytorch_geometric_tpu/parallel/models.py``: each layer
is the same conv class the single-device path uses (``GCNConv``,
``SAGEConv``, ``GATConv``, ``RGCNConv``), called with a
:class:`~pytorch_geometric_tpu_torch.parallel.api.ShardCtx` as
``shard_ctx=``. The layers keep the JAX names (``conv1``, ``conv2``) and
parameter layouts, so ``convert.params_from_jax`` carries a JAX model's
weights over unchanged. ``forward(ctx, x, train, generator)``: ``x``
this rank's (S, F) shard; dropout draws from ``generator``.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.nn.conv.gat_conv import GATConv
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import GCNConv
from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import RGCNConv
from pytorch_geometric_tpu_torch.nn.conv.sage_conv import SAGEConv
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.layers import dropout


def reset_parameters(model: nn.Module, generator: torch.Generator):
    """Redraw every parameter in registration order as the convs'
    constructors draw them: biases zeros, the others glorot from
    ``generator``. A Dist model built with ``generator=g`` equals one
    reset from a generator in ``g``'s state before the build."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            new = zeros(p.shape) if name.endswith("bias") \
                else glorot(tuple(p.shape), generator)
            p.copy_(new.to(p.device))


class DistGCN(nn.Module):
    """2-layer GCN over an edge partition (models/citation.py's GCN):
    dropout, conv1, ReLU, dropout, conv2."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_classes: int, dropout_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.conv1 = GCNConv(in_channels, hidden_channels,
                             generator=generator)
        self.conv2 = GCNConv(hidden_channels, num_classes,
                             generator=generator)

    def forward(self, ctx, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = dropout(x, self.dropout_rate, train, generator)
        x = torch.relu(self.conv1(None, x, shard_ctx=ctx))
        x = dropout(x, self.dropout_rate, train, generator)
        return self.conv2(None, x, shard_ctx=ctx)


class DistSAGE(nn.Module):
    """2-layer GraphSAGE (self-inclusive mean) over an edge partition."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_classes = num_classes
        self.conv1 = SAGEConv(in_channels, hidden_channels,
                              generator=generator)
        self.conv2 = SAGEConv(hidden_channels, num_classes,
                              generator=generator)

    def forward(self, ctx, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = torch.relu(self.conv1(None, x, shard_ctx=ctx))
        return self.conv2(None, x, shard_ctx=ctx)


class DistRGCN(nn.Module):
    """2-layer relational GCN over an edge partition (examples/rgcn.py's
    Net on dense inputs; the ``GraphPartition`` is built with
    ``edge_type=`` / ``num_relations=``)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_classes: int, num_relations: int, num_bases: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.num_classes = num_classes
        self.num_relations = num_relations
        self.num_bases = num_bases
        self.conv1 = RGCNConv(in_channels, hidden_channels, num_relations,
                              num_bases=num_bases, generator=generator)
        self.conv2 = RGCNConv(hidden_channels, num_classes, num_relations,
                              num_bases=num_bases, generator=generator)

    def forward(self, ctx, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = torch.relu(self.conv1(None, x, shard_ctx=ctx))
        return self.conv2(None, x, shard_ctx=ctx)


class DistGAT(nn.Module):
    """2-layer GAT over an edge partition (examples/gat.py): ``heads``
    concatenated heads, ELU, one averaged head."""

    def __init__(self, in_channels: int, num_classes: int,
                 hidden_channels: int = 8, heads: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.hidden_channels = hidden_channels
        self.heads = heads
        self.conv1 = GATConv(in_channels, hidden_channels, heads=heads,
                             generator=generator)
        self.conv2 = GATConv(heads * hidden_channels, num_classes, heads=1,
                             concat=False, generator=generator)

    def forward(self, ctx, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = torch.nn.functional.elu(self.conv1(None, x, shard_ctx=ctx))
        return self.conv2(None, x, shard_ctx=ctx)
