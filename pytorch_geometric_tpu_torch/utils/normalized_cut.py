"""Normalized-cut edge weights, in torch: w'_ij = w_ij (1 / deg(i) +
1 / deg(j)), with deg the weighted in-degree and 1 / 0 taken as 0.

Counterpart of ``pytorch_geometric_tpu/utils/normalized_cut.py``
(reference: torch_geometric.utils.normalized_cut,
examples/mnist_graclus.py:8,22-25).
"""

import torch

from pytorch_geometric_tpu_torch.utils.degree import degree


def normalized_cut(senders, receivers, edge_weight, num_nodes, mask=None):
    senders, receivers = senders.long(), receivers.long()
    deg = degree(receivers, num_nodes, dtype=edge_weight.dtype, mask=mask)
    inv = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-12), 0.0)
    out = edge_weight * (inv[senders] + inv[receivers])
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out
