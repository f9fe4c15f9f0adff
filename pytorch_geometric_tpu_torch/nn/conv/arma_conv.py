"""ARMA convolution (Bianchi et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/arma_conv.py`` (reference:
``torch_geometric.nn.ARMAConv``, PyG 1.4.x):

  x_k^(t+1) = act(L̂ x_k^(t) W_k^(t) + x^(0) V_k^(t)),
  L̂ = D^-1/2 A D^-1/2 (no self loops), output = mean over the K stacks.

``shared_weights`` ties W and V across t >= 1; dropout applies to the
skip input x^(0) at every layer, drawn from the caller's generator.

L̂'s weights depend only on the graph, so each L̂ product is the bound
SpMM ``lap_fn`` (:func:`arma_operator`): on a CUDA tensor one
``spmm_csr`` launch a layer, for all K stacks at once over (N, K·C)
channels (stack k's channels are k·C to k·C + C - 1). Each channel's sum
is the one of the JAX module's per-stack loop. Without ``lap_fn``, on the
CPU only, the plain ``spmm`` over the graph's edges.
"""

from typing import Callable, Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.layers import dropout
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm


def arma_lap_weights(graph: Graph, edge_weight=None):
    """L̂'s weight on each edge: ``dis[s] w dis[r]`` with the receivers'
    weighted degree (padding edges weigh 0 unless ``edge_weight`` says
    otherwise)."""
    if edge_weight is None:
        edge_weight = graph.real_edge_mask().float()
    deg = segment_sum(edge_weight, graph.receivers, graph.num_nodes)
    dis = torch.where(deg > 0, deg.clamp_min(1e-12) ** -0.5, 0.0)
    return dis[graph.senders.long()] * edge_weight \
        * dis[graph.receivers.long()]


def arma_edge_set(graph: Graph, edge_weight=None):
    """``(senders, receivers, weights)`` of L̂ over the real edges: the
    padding edges weigh 0 and are left out, so no sum changes."""
    w = arma_lap_weights(graph, edge_weight)
    keep = graph.real_edge_mask()
    return graph.senders[keep], graph.receivers[keep], w[keep]


def arma_operator(graph: Graph, edge_weight=None):
    """``lap_fn``: L̂ as ``SpmmOperator.bind`` over :func:`arma_edge_set`,
    on the graph's device, built on the host."""
    s, r, w = arma_edge_set(graph, edge_weight)
    return SpmmOperator(s, r, graph.num_nodes, device=graph.device).bind(w)


def _stacked(w):
    """(K, F, C) -> (F, K·C): one product gives every stack's channels."""
    K, F, C = w.shape
    return w.permute(1, 0, 2).reshape(F, K * C)


class ARMAConv(nn.Module):
    """Parameters as in the JAX module: ``init_weight`` (K, F, C),
    ``weight`` (max(n_w - 1, 1), K, C, C) when ``num_layers`` > 1,
    ``root_weight`` (n_w, K, F, C), ``bias`` (T or 1, K, 1, C), with n_w
    = 1 when ``shared_weights`` else ``num_layers``."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_stacks: int = 1, num_layers: int = 1,
                 shared_weights: bool = False, dropout: float = 0.0,
                 use_bias: bool = True, act: Callable = torch.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        K, F, C = num_stacks, in_channels, out_channels
        self.num_stacks, self.num_layers = K, num_layers
        self.shared_weights, self.dropout, self.act = (shared_weights,
                                                       dropout, act)
        n_w = 1 if shared_weights else num_layers
        self.init_weight = nn.Parameter(glorot((K, F, C), generator))
        self.weight = nn.Parameter(glorot((max(n_w - 1, 1), K, C, C),
                                          generator)) \
            if num_layers > 1 else None
        self.root_weight = nn.Parameter(glorot((n_w, K, F, C), generator))
        self.bias = nn.Parameter(zeros((1 if shared_weights else num_layers,
                                        K, 1, C))) if use_bias else None

    def forward(self, graph: Graph, x, edge_weight=None, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None, lap_fn=None):
        N, K = graph.num_nodes, self.num_stacks
        C = self.init_weight.shape[-1]
        if lap_fn is None:
            require_cpu(x, "ARMAConv", "lap_fn (arma_operator)")
            lap_w = arma_lap_weights(graph, edge_weight)

            def lap_fn(h):
                return spmm(graph.senders, graph.receivers, h, N,
                            weights=lap_w)

        def skip(v):
            return dropout(x, self.dropout, train, generator) \
                @ _stacked(self.root_weight[v])

        def bias(b):
            return 0.0 if self.bias is None else self.bias[b].reshape(K * C)

        out = self.act(lap_fn(x @ _stacked(self.init_weight)) + skip(0)
                       + bias(0))
        for t in range(1, self.num_layers):
            wi = 0 if self.shared_weights else t - 1
            vi = 0 if self.shared_weights else t
            h = torch.einsum("nkc,kcd->nkd", out.reshape(N, K, C),
                             self.weight[wi]).reshape(N, K * C)
            out = self.act(lap_fn(h) + skip(vi) + bias(vi))
        return out.reshape(N, K, C).mean(1)
