"""Chebyshev spectral convolution (Defferrard et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/cheb_conv.py`` (reference:
``torch_geometric.nn.ChebConv``, PyG 1.4.x, lambda_max taken as 2):
L~ = -D^-1/2 A D^-1/2; T_0 = x, T_1 = L~ x, T_k = 2 L~ T_{k-1} - T_{k-2};
out = sum_k T_k W_k + b.

L~'s weights depend only on the graph, so each of the K - 1 products is
the bound SpMM ``lap_fn`` (:func:`cheb_operator`): one ``spmm_csr``
launch each on a CUDA tensor. Without it, on the CPU only, the plain
``spmm``.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.conv.arma_conv import (
    arma_edge_set, arma_lap_weights)
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm


def cheb_operator(graph: Graph, edge_weight=None):
    """``lap_fn``: L~ = -L̂ as ``SpmmOperator.bind`` over the real edges
    (``arma_edge_set``), built on the host."""
    s, r, w = arma_edge_set(graph, edge_weight)
    return SpmmOperator(s, r, graph.num_nodes, device=graph.device).bind(-w)


class ChebConv(nn.Module):
    """``weight`` (K, in, out), ``bias`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K = K
        self.weight = nn.Parameter(glorot((K, in_channels, out_channels),
                                          generator))
        self.bias = nn.Parameter(zeros((out_channels,))) if use_bias \
            else None

    def forward(self, graph: Graph, x, edge_weight=None, lap_fn=None):
        if lap_fn is None and self.K > 1:
            require_cpu(x, "ChebConv", "lap_fn (cheb_operator)")
            lap_w = -arma_lap_weights(graph, edge_weight)

            def lap_fn(h):
                return spmm(graph.senders, graph.receivers, h,
                            graph.num_nodes, weights=lap_w)

        out = x @ self.weight[0]
        if self.K > 1:
            tx_prev_prev, tx_prev = x, lap_fn(x)
            out = out + tx_prev @ self.weight[1]
            for k in range(2, self.K):
                tx = 2.0 * lap_fn(tx_prev) - tx_prev_prev
                out = out + tx @ self.weight[k]
                tx_prev_prev, tx_prev = tx_prev, tx
        return out + self.bias if self.bias is not None else out
