"""AGNN convolution (Thekumparampil et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/agnn_conv.py`` (reference:
``torch_geometric.nn.AGNNConv``): P_ij = softmax_j(beta cos(x_i, x_j))
over N(i) and i itself; x' = P x. beta is trained iff ``requires_grad``.

Through the graph's operators (:func:`agnn_operators`, built once per
graph over :func:`agnn_edge_set`):

- the cosines are an SDDMM of the row-normalised x over the edges and
  the self loops, its two gathers ``send_op.gather`` / ``recv_op.gather``;
- the per-receiver softmax's max over the E scalars is torch's
  ``scatter_reduce``; its sum is ``recv_op`` (the segment-sum kernel at
  one channel), and the sums spread back to the edges by
  ``recv_op.gather``;
- the aggregation is ``spmm_op(alpha, x)`` (``SpmmOperator.__call__``):
  the ``spmm_csr`` kernel, differentiable in alpha (the operator's SDDMM)
  and in x (the transposed CSR).

Every sum, forward and backward, so runs in a fixed order, and two runs
from the same inputs agree bit for bit (torch's gathers scatter their
gradients with atomics; its ``index_add_`` sums in an order that varies).
Without the operators, on the CPU only, the JAX module's plain path:
every edge (padding edges masked out of the softmax) and segment sums.
"""

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.sddmm import edge_gather, sddmm
from pytorch_geometric_tpu_torch.ops.segment import (
    segment_softmax, segment_sum)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator


def agnn_edge_set(graph: Graph):
    """``(senders, receivers)`` of the attention: the real edges and one
    self loop per node, padding nodes' included. The padding edges, whose
    attention the softmax masks to 0, are left out, so no receiver's
    softmax or sum changes."""
    n = graph.num_nodes
    loop = torch.arange(n, dtype=graph.senders.dtype, device=graph.device)
    keep = graph.real_edge_mask()
    return (torch.cat([graph.senders[keep], loop]),
            torch.cat([graph.receivers[keep], loop]))


def agnn_operators(graph: Graph):
    """``{"spmm_op", "recv_op", "send_op"}`` of :func:`agnn_edge_set` on
    the graph's device, built on the host: the ``SpmmOperator`` of the
    aggregation and the ``SortedSegmentSum`` over its receivers and over
    its senders."""
    s, r = agnn_edge_set(graph)
    n, dev = graph.num_nodes, graph.device
    return {"spmm_op": SpmmOperator(s, r, n, device=dev),
            "recv_op": SortedSegmentSum(r, n, device=dev),
            "send_op": SortedSegmentSum(s, n, device=dev)}


class AGNNConv(nn.Module):

    def __init__(self, requires_grad: bool = True):
        super().__init__()
        self.requires_grad = requires_grad
        self.beta = nn.Parameter(torch.ones(1)) if requires_grad else None

    def forward(self, graph: Graph, x, spmm_op: SpmmOperator = None,
                recv_op: SortedSegmentSum = None,
                send_op: SortedSegmentSum = None):
        n = graph.num_nodes
        xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)
        if spmm_op is None:
            return self._plain(graph, x, xn)
        cos = (send_op.gather(xn) * recv_op.gather(xn)).sum(-1)
        logits = self.beta[0] * cos if self.beta is not None else cos
        receivers = spmm_op.receivers
        seg_max = logits.new_full((n,), float("-inf")).scatter_reduce_(
            0, receivers, logits.detach(), "amax", include_self=True)
        seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
        exp = torch.exp(logits - seg_max[receivers])
        denom = recv_op(exp)
        denom = torch.where(denom == 0.0, 1.0, denom)
        return spmm_op(exp / recv_op.gather(denom), x)

    def _plain(self, graph: Graph, x, xn):
        require_cpu(x, "AGNNConv", "spmm_op, recv_op and send_op "
                    "(agnn_operators)")
        n = graph.num_nodes
        loop = torch.arange(n, dtype=graph.senders.dtype, device=x.device)
        senders = torch.cat([graph.senders, loop])
        receivers = torch.cat([graph.receivers, loop])
        mask = torch.cat([graph.real_edge_mask(),
                          torch.ones(n, dtype=torch.bool, device=x.device)])
        cos = sddmm(senders, receivers, xn)
        logits = self.beta[0] * cos if self.beta is not None else cos
        alpha = segment_softmax(logits, receivers, n, mask=mask)
        return segment_sum(edge_gather(x, senders) * alpha[:, None],
                           receivers, n)
