"""DNA convolution: dynamic neighbourhood aggregation (Fey, 2019).

Counterpart of ``pytorch_geometric_tpu/nn/conv/dna_conv.py`` (reference:
``torch_geometric.nn.DNAConv``). Node i holds its layer history
x_i^(1..L); each edge (j -> i) runs multi-head scaled dot-product
attention over the history, with the query from x_i^(L) and keys and
values from x_j's history; the messages are summed with GCN's symmetric
normalisation, self loops included. The projections are grouped
(block-diagonal weights).

The attention over the layer axis is a dense softmax over L, in torch,
as in the JAX module. Through the graph's operators (:func:`dna_operators`,
built once per graph over the normalised edge set): the final sum of the
weighted messages by receiver is ``segment_op``, a ``SortedSegmentSum``
over the receivers (the ``sorted_segment_sum`` kernel on a CUDA tensor);
the gathers of the queries by receiver and of the keys and values by
sender are ``segment_op.gather`` and ``sender_op.gather``, whose
backward is the same kernel over the receivers and over the senders, so
that every sum runs in a fixed order and two runs agree bit for bit.
Without them, on the CPU only, plain gathers and a segment sum over
``gcn_norm``'s edges.
"""

import math
from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (
    EdgeNorm, gcn_edge_set, gcn_norm)
from pytorch_geometric_tpu_torch.nn.inits import kaiming_uniform, zeros
from pytorch_geometric_tpu_torch.nn.layers import dropout
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum


def dna_operators(graph: Graph):
    """``{"norm", "segment_op", "sender_op"}`` for ``DNAConv`` on the
    graph's device: the ``gcn_norm`` edge set without its padding edges
    (``gcn_edge_set``: they weigh 0, so no sum changes) and the
    ``SortedSegmentSum`` over its receivers and over its senders. Built on
    the host."""
    norm = EdgeNorm(*gcn_edge_set(graph))
    n, dev = graph.num_nodes, graph.device
    return {"norm": norm,
            "segment_op": SortedSegmentSum(norm.receivers, n, device=dev),
            "sender_op": SortedSegmentSum(norm.senders, n, device=dev)}


class _GroupedLinear(nn.Module):
    def __init__(self, channels: int, groups: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = groups, channels
        self.groups = groups
        self.weight = nn.Parameter(kaiming_uniform((g, c // g, c // g),
                                                   generator))
        self.bias = nn.Parameter(zeros((c,)))

    def forward(self, x):
        # one product with the block-diagonal (C, C) weight: the JAX
        # module's per-group einsum, each output a sum over its group only
        return x @ torch.block_diag(*self.weight) + self.bias


class DNAConv(nn.Module):
    """``lin_q``, ``lin_k``, ``lin_v``: grouped linears of ``channels``."""

    def __init__(self, channels: int, heads: int = 1, groups: int = 1,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dropout = heads, dropout
        self.lin_q = _GroupedLinear(channels, groups, generator)
        self.lin_k = _GroupedLinear(channels, groups, generator)
        self.lin_v = _GroupedLinear(channels, groups, generator)

    def forward(self, graph: Graph, x_all, norm: Optional[EdgeNorm] = None,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                segment_op: Optional[SortedSegmentSum] = None,
                sender_op: Optional[SortedSegmentSum] = None):
        """``x_all`` (N, L, C): the layer history."""
        N, L, C = x_all.shape
        H = self.heads
        if segment_op is None:
            require_cpu(x_all, "DNAConv", "norm, segment_op and sender_op "
                        "(dna_operators)")
        q = self.lin_q(x_all[:, -1]).reshape(N, H, C // H)
        kv = torch.cat([self.lin_k(x_all), self.lin_v(x_all)], dim=-1)
        if segment_op is None:
            norm = gcn_norm(graph) if norm is None else norm
            q_i = q.index_select(0, norm.receivers.long())
            kv_j = kv.index_select(0, norm.senders.long())
        else:
            q_i = segment_op.gather(q)                    # (E', H, D)
            kv_j = sender_op.gather(kv)                   # (E', L, 2C)
        k_j = kv_j[..., :C].reshape(-1, L, H, C // H)     # (E', L, H, D)
        v_j = kv_j[..., C:].reshape(-1, L, H, C // H)
        # the JAX module's einsums "ehd,elhd->elh" and "elh,elhd->ehd" as
        # products and sums over one axis: a batched product of 1-row
        # matrices per (edge, head) would be mostly launch and tiling
        scores = (q_i[:, None] * k_j).sum(-1) / math.sqrt(C // H)
        alpha = torch.softmax(scores, dim=1)              # over the history
        alpha = dropout(alpha, self.dropout, train, generator)
        msg = (alpha[..., None] * v_j).sum(1).reshape(-1, C)
        msg = msg * norm.weights[:, None]
        if segment_op is not None:
            return segment_op(msg)
        return segment_sum(msg, norm.receivers, N)
