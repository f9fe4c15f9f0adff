"""Set2Set global readout (Vinyals et al.).

Counterpart of ``pytorch_geometric_tpu/nn/pool/set2set.py`` (reference:
``torch_geometric.nn.Set2Set``; examples/qm9_nn_conv.py:9,78,91,
processing_steps=3): LSTM(q*_{t-1}) -> q_t; alpha = softmax_i(x_i . q_t)
per graph over its real nodes; r_t = sum_i alpha_i x_i; q*_t = [q_t ||
r_t]; the output is q*_T, (num_graphs, 2F).

The LSTM is ``torch.nn.LSTMCell(2F, F)`` with a zero initial carry,
named ``OptimizedLSTMCell_0`` after the flax cell whose parameters
``convert.params_from_jax`` maps onto it.

Through the batch's ``SortedSegmentSum`` over ``batch`` (``segment_op``,
``nn/pool/global_pool.py:pool_operator``) every sum of the readout runs
in the segment-sum kernel on a card: the softmax's denominators and the
weighted sum r; ``q[batch]`` and ``denom[batch]`` are the operator's
``gather``, whose backward is the kernel too. The softmax's max is
torch's ``scatter_reduce``. Without the operator, on the CPU only, the
JAX module's plain segment ops; on a CUDA tensor it raises.
"""

from typing import Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.layers import lstm_cell
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.segment import (
    segment_softmax, segment_sum)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum


def _softmax_sum(x, e, batch, nm, G, op: SortedSegmentSum):
    """``sum_i alpha_i x_i`` per graph, alpha the masked softmax of ``e``
    per graph, every sum through ``op``."""
    logits = torch.where(nm, e, float("-inf"))
    seg_max = logits.new_full((G,), float("-inf")).scatter_reduce_(
        0, batch, logits.detach(), "amax", include_self=True)
    seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    exp = torch.where(nm, torch.exp(logits - seg_max[batch]), 0.0)
    denom = op(exp[:, None])
    denom = torch.where(denom == 0.0, 1.0, denom)
    alpha = exp / op.gather(denom)[:, 0]
    return op(x * alpha[:, None] * nm[:, None].to(x.dtype))


class Set2Set(nn.Module):

    def __init__(self, in_channels: int, processing_steps: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.processing_steps = processing_steps
        self.OptimizedLSTMCell_0 = lstm_cell(2 * in_channels, in_channels,
                                             generator)

    def forward(self, x, graph: Graph,
                segment_op: Optional[SortedSegmentSum] = None):
        N, F = x.shape
        G = graph.num_graphs
        batch = graph.batch.long() if graph.batch is not None else \
            torch.zeros((N,), dtype=torch.int64, device=x.device)
        nm = graph.real_node_mask()
        if segment_op is None:
            require_cpu(x, "Set2Set", "segment_op (pool_operator)")
        elif segment_op.num_nodes != G:
            raise ValueError(f"Set2Set: segment_op has "
                             f"{segment_op.num_nodes} rows, expected {G}")
        h = c = x.new_zeros((G, F))
        q_star = x.new_zeros((G, 2 * F))
        for _ in range(self.processing_steps):
            h, c = self.OptimizedLSTMCell_0(q_star, (h, c))
            q = h                                          # (G, F)
            if segment_op is None:
                e = (x * q[batch]).sum(-1)                 # (N,)
                alpha = segment_softmax(e, batch, G, mask=nm)
                r = segment_sum(x * alpha[:, None] *
                                nm[:, None].to(x.dtype), batch, G)
            else:
                e = (x * segment_op.gather(q)).sum(-1)
                r = _softmax_sum(x, e, batch, nm, G, segment_op)
            q_star = torch.cat([q, r], dim=-1)
        return q_star
