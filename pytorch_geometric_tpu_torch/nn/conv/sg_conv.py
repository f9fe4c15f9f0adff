"""Simplified Graph Convolution (Wu et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/sg_conv.py`` (reference:
``torch_geometric.nn.SGConv`` with ``cached=True``): x' = Â^K x W + b with
Â = D^-1/2 (A + I) D^-1/2.

The propagated features depend only on the static graph, so
:func:`sgc_precompute` runs once and is passed back in as ``cached_x``;
training is then one matrix product. Its K products go through
``aggregate_fn``, the graph's ``SpmmOperator.bind`` of the ``gcn_norm``
weights (``models/citation.py:gcn_spmm_operator``): K ``spmm_csr``
launches on a CUDA tensor. Without it they run as the plain ``spmm``,
on the CPU only.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import gcn_norm
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.spmm import spmm


def sgc_precompute(graph: Graph, x, K: int, aggregate_fn=None):
    """Â^K x, the cacheable part: K calls of ``aggregate_fn`` (the bound
    SpMM of the ``gcn_norm`` weights), or of the plain ``spmm`` over
    ``gcn_norm`` on the CPU."""
    if aggregate_fn is None:
        require_cpu(x, "sgc_precompute", "aggregate_fn, the bound SpMM")
        norm = gcn_norm(graph)

        def aggregate_fn(h):
            return spmm(norm.senders, norm.receivers, h, graph.num_nodes,
                        weights=norm.weights)

    for _ in range(K):
        x = aggregate_fn(x)
    return x


class SGConv(nn.Module):
    """``weight`` (in, out), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, K: int = 1,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K = K
        self.weight = nn.Parameter(glorot((in_channels, out_channels),
                                          generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, cached_x=None, aggregate_fn=None):
        h = cached_x if cached_x is not None else \
            sgc_precompute(graph, x, self.K, aggregate_fn)
        out = h @ self.weight
        return out + self.bias if self.bias is not None else out
