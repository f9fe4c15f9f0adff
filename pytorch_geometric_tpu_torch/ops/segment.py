"""Segment reductions on ``index_add_`` / ``scatter_reduce``.

Counterpart of ``pytorch_geometric_tpu/ops/segment.py`` (the reference's
torch-scatter): reduce rows of ``data`` into ``num_segments`` buckets by
``segment_ids`` along dim 0, with the same empty-segment fills:

- ``segment_sum`` / ``segment_mean``: 0 (mean divides by max(count, 1));
- ``segment_max`` / ``segment_min``: 0 for floating data, also where a
  segment holds only -inf (+inf for min), since the JAX package maps
  every -inf / +inf of the result to 0; the integer identity otherwise;
- ``segment_softmax``: segments whose entries are all masked give 0.

``indices_are_sorted`` is accepted and passed on for signature parity;
the torch reductions take any order and ignore it.
"""

import torch


def _expand(index, data):
    return index.long().reshape(
        index.shape + (1,) * (data.ndim - 1)).expand_as(data)


def segment_sum(data, segment_ids, num_segments, indices_are_sorted=False):
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data, segment_ids, num_segments, indices_are_sorted=False):
    """Mean-reduce rows per segment; empty segments produce 0."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                         num_segments).clamp_min(1)
    return totals / counts.reshape((-1,) + (1,) * (data.ndim - 1))


def _segment_extreme(data, segment_ids, num_segments, reduce):
    shape = (num_segments,) + tuple(data.shape[1:])
    if data.is_floating_point():
        # include_self=False leaves empty segments at this fill, mapped to
        # 0 below; an infinite fill never ties with a segment's extreme,
        # so the backward splits the gradient among the data's ties only,
        # as JAX does (a fill of 0 counted itself as a tie of a 0 max)
        out = data.new_full(shape, float("-inf") if reduce == "amax"
                            else float("inf"))
    else:
        info = torch.iinfo(data.dtype)
        out = data.new_full(shape, info.min if reduce == "amax"
                            else info.max)
    out = out.scatter_reduce_(0, _expand(segment_ids, data), data, reduce,
                              include_self=False)
    if data.is_floating_point():
        # an empty segment, or one of -inf entries (+inf for min), gives
        # 0, as in JAX
        out = torch.where(torch.isneginf(out) if reduce == "amax"
                          else torch.isposinf(out), 0.0, out)
    return out


def segment_max(data, segment_ids, num_segments, indices_are_sorted=False):
    """Max-reduce rows per segment; empty segments produce 0 (like the
    reference's scatter_max fill of the output buffer)."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments, indices_are_sorted=False):
    return _segment_extreme(data, segment_ids, num_segments, "amin")


_REDUCERS = {
    "add": segment_sum,
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def scatter(src, index, num_segments, reduce="add", indices_are_sorted=False):
    """torch-scatter-compatible entry point: ``scatter(src, index, reduce)``
    along dim 0 (the only dim the reference uses)."""
    try:
        fn = _REDUCERS[reduce]
    except KeyError:
        raise ValueError(
            f"Unknown reduce '{reduce}'; expected one of {list(_REDUCERS)}")
    return fn(src, index, num_segments, indices_are_sorted=indices_are_sorted)


def segment_softmax(logits, segment_ids, num_segments,
                    indices_are_sorted=False, mask=None):
    """Numerically stable softmax over entries sharing a segment id.

    GAT's edge-attention normaliser: softmax over the incoming edges of
    each target node. ``mask`` (bool per entry) excludes padding edges
    from the normalisation.
    """
    if mask is not None:
        mask = mask.reshape(mask.shape + (1,) * (logits.ndim - mask.ndim))
        logits = torch.where(mask, logits, float("-inf"))
    shape = (num_segments,) + tuple(logits.shape[1:])
    seg_max = logits.new_full(shape, float("-inf")).scatter_reduce_(
        0, _expand(segment_ids, logits), logits.detach(), "amax",
        include_self=True)
    seg_max = torch.where(torch.isneginf(seg_max), 0.0, seg_max)
    exp = torch.exp(logits - seg_max[segment_ids.long()])
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return exp / denom[segment_ids.long()]
