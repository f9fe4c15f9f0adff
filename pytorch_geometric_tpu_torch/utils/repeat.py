"""Scalar/list broadcast helper (counterpart of
``pytorch_geometric_tpu/utils/repeat.py``; reference:
torch_geometric.utils.repeat, which SplineConv uses for its per-dimension
kernel sizes)."""

import itertools


def repeat(src, length: int):
    """``src`` as a list of ``length`` entries: a scalar repeated, a
    longer sequence cut, a shorter one cycled."""
    if src is None:
        return None
    if isinstance(src, (int, float)):
        return [src] * length
    src = list(src)
    if len(src) > length:
        return src[:length]
    if len(src) < length:
        return src + list(itertools.islice(
            itertools.cycle(src), length - len(src)))
    return src
