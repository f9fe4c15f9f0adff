"""Segment softmax at the utils level (counterpart of
``pytorch_geometric_tpu/utils/softmax.py``; reference:
torch_geometric.utils.softmax): an alias of ``ops/segment.py``'s
:func:`segment_softmax`."""

from pytorch_geometric_tpu_torch.ops.segment import segment_softmax


def softmax(src, index, num_nodes, mask=None, indices_are_sorted=False):
    return segment_softmax(src, index, num_nodes, mask=mask,
                           indices_are_sorted=indices_are_sorted)
