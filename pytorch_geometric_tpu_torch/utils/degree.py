"""Node degree (counterpart of ``pytorch_geometric_tpu/utils/degree.py``;
reference: torch_geometric.utils.degree)."""

import torch

from pytorch_geometric_tpu_torch.ops.segment import segment_sum


def degree(index, num_nodes, dtype=torch.float32, weights=None, mask=None):
    """Count (or weight-sum) of entries per node id in ``index``.

    ``mask`` excludes padding edges (padding already routes to the padding
    node, so this only matters when indices were filtered in place)."""
    ones = torch.ones(index.shape, dtype=dtype, device=index.device) \
        if weights is None else weights
    if mask is not None:
        ones = torch.where(mask, ones, torch.zeros_like(ones))
    return segment_sum(ones, index, num_nodes)
