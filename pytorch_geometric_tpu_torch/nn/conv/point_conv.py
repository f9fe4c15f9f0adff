"""PointNet++ set-abstraction convolution (Qi et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/point_conv.py``
(reference: ``torch_geometric.nn.PointConv``):
out_i = global_nn(max_{j in N(i)} local_nn([x_j || p_j - p_i])).

The neighbourhood (senders into the source set, receivers into the
destination set) is given explicitly; the max is torch's
``scatter_reduce`` (``ops/segment.py:segment_max``), for which neither
package has a kernel. Bipartite mode: ``pos`` is ``(pos_src, pos_dst)``.
``sender_op``, a ``SortedSegmentSum`` over the senders, gathers ``x_j``
(its ``gather``): the gradient of ``x`` then sums by sender in the
segment-sum kernel, in a fixed order, where torch's gather backward adds
with atomics in an order that varies from run to run.
"""

from typing import Callable, Optional

import torch
from torch import nn

from pytorch_geometric_tpu_torch.ops.segment import segment_max


class PointConv(nn.Module):

    def __init__(self, local_nn: Optional[Callable] = None,
                 global_nn: Optional[Callable] = None):
        super().__init__()
        self.local_nn, self.global_nn = local_nn, global_nn

    def forward(self, x, pos, senders, receivers, num_dst: int,
                edge_mask=None, sender_op=None):
        """``x`` (N_src, F) or None; ``pos`` (N_src, D) or a pair."""
        pos_src, pos_dst = pos if isinstance(pos, tuple) else (pos, pos)
        senders, receivers = senders.long(), receivers.long()
        rel = pos_src.index_select(0, senders) \
            - pos_dst.index_select(0, receivers)
        if x is not None:
            x_j = sender_op.gather(x) if sender_op is not None else \
                x.index_select(0, senders)
        msg = rel if x is None else torch.cat([x_j, rel], dim=-1)
        if self.local_nn is not None:
            msg = self.local_nn(msg)
        if edge_mask is not None:
            msg = torch.where(edge_mask[:, None], msg,
                              torch.finfo(msg.dtype).min)
        out = segment_max(msg, receivers, num_dst)
        return self.global_nn(out) if self.global_nn is not None else out
