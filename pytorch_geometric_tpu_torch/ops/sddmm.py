"""SDDMM-shaped ops: per-edge values from endpoint features.

Counterpart of ``pytorch_geometric_tpu/ops/sddmm.py``. The JAX package
computes them in XLA, with no Pallas kernel; here they are plain PyTorch
gathers and a reduction, which AGNN's cosines and the SpMM's weight
gradient use.
"""

import torch


def edge_gather(x, index):
    """Per-edge gather of node rows: ``x_j = x[index]``."""
    return x.index_select(0, index.long())


def sddmm(senders, receivers, a, b=None):
    """Per-edge dot products ``out[e] = <a[senders[e]], b[receivers[e]]>``.

    ``a`` / ``b``: (N, F) or (N, H, F) for multi-head; returns (E,) or
    (E, H)."""
    if b is None:
        b = a
    return (edge_gather(a, senders) * edge_gather(b, receivers)).sum(-1)
