"""Deep Graph Infomax (Veličković et al.).

Counterpart of ``pytorch_geometric_tpu/nn/models/infomax.py`` (reference:
the hand-built Infomax of examples/infomax.py:49-67, encoder +
corruption + bilinear discriminator + readout, with the
``nn.inits.uniform`` weight init at :42; packaged like upstream PyG's
``DeepGraphInfomax``). The corruption takes a ``torch.Generator``: the
example's permutes the node rows with ``torch.randperm``.
"""

from typing import Callable, Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.nn.inits import uniform


class DeepGraphInfomax(nn.Module):
    """``encoder``: a module ``(graph, x) -> (N, H)``; ``corruption``:
    ``(graph, x, rng) -> (graph', x')``; ``summary``: ``z -> (H,)``,
    default sigmoid of the mean over every row."""

    def __init__(self, hidden_channels: int, encoder: nn.Module,
                 corruption: Callable, summary: Optional[Callable] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.encoder = encoder
        self.corruption = corruption
        self.summary = summary

    def forward(self, graph, x, *, rng: Optional[torch.Generator] = None,
                **encoder_kwargs):
        """``(pos_z, neg_z, summary)``; ``encoder_kwargs`` (the graph's
        operators) go to both encoder calls."""
        pos_z = self.encoder(graph, x, **encoder_kwargs)
        cor_graph, cor_x = self.corruption(graph, x, rng)
        neg_z = self.encoder(cor_graph, cor_x, **encoder_kwargs)
        if self.summary is None:
            s = torch.sigmoid(pos_z.mean(0))
        else:
            s = self.summary(pos_z)
        return pos_z, neg_z, s

    def discriminate(self, z, summary, weight):
        return z @ weight @ summary


def infomax_loss_fn(pos_z, neg_z, summary, weight):
    """BCE discriminator loss (examples/infomax.py:55-60)."""
    eps = 1e-15
    pos = torch.sigmoid(pos_z @ weight @ summary)
    neg = torch.sigmoid(neg_z @ weight @ summary)
    return -torch.log(pos + eps).mean() - torch.log(1 - neg + eps).mean()


class InfomaxHead(nn.Module):
    """Bilinear discriminator weight holder (uniform init, matching
    examples/infomax.py:42)."""

    def __init__(self, hidden_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.weight = nn.Parameter(uniform(hidden_channels)(
            (hidden_channels, hidden_channels), generator))

    def forward(self, pos_z, neg_z, summary):
        return infomax_loss_fn(pos_z, neg_z, summary, self.weight)
