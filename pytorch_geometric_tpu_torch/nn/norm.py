"""Normalisation layers for padded node sets.

Counterpart of ``pytorch_geometric_tpu/nn/norm.py`` (reference: the
``torch.nn.BatchNorm1d`` over nodes of examples/mutag_gin.py:25-43). The
node axis of a collated batch holds padding rows, so the batch moments
are masked: padding rows are left out of the mean and the variance.

``MaskedBatchNorm`` is its own module rather than ``nn.BatchNorm1d``,
because it keeps the JAX module's running statistics:

- they follow flax's convention, ``ra = momentum * ra + (1 - momentum) *
  batch`` (momentum 0.9);
- the running variance is the biased masked variance of the batch (torch
  keeps the unbiased one);
- they are buffers named ``mean`` and ``var``, the JAX ``batch_stats``
  collection, which ``convert.params_from_jax`` carries across.

``train=True`` normalises by the batch moments (differentiable) and
updates the running statistics; ``train=False`` normalises by the running
statistics.
"""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """``scale`` and ``bias`` (F,) parameters; ``mean`` and ``var`` (F,)
    buffers, initially 0 and 1."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.scale = nn.Parameter(torch.ones(num_features)) if use_scale \
            else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias \
            else None

    def forward(self, x, mask=None, *, train: bool = False):
        if train:
            if mask is None:
                mean = x.mean(0)
                var = x.var(0, unbiased=False)
            else:
                m = mask.to(x.dtype)[:, None]
                cnt = m.sum().clamp_min(1.0)
                mean = (x * m).sum(0) / cnt
                var = (((x - mean) ** 2) * m).sum(0) / cnt
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) / torch.sqrt(var + self.epsilon)
        if self.scale is not None:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y
