"""The port's counterparts of the two ``flax.linen`` layers that the JAX
package's models and examples use:

- :class:`Dense`: ``kernel`` is (in, out), as in flax, so
  ``y = x @ kernel + bias`` and ``convert.params_from_jax`` carries a
  flax ``Dense``'s parameters across unchanged. The kernel is drawn as
  flax's default ``lecun_normal``: a normal of variance 1 / fan_in
  truncated at two standard deviations.
- :func:`dropout`: ``flax.linen.Dropout``'s inverted dropout, with the
  mask drawn from the caller's generator.
"""

import math
from typing import Optional

import torch
from torch import nn


def lecun_normal(shape, generator=None, dtype=torch.float32, device=None):
    """Truncated normal over [-2, 2] standard deviations, scaled so that
    its variance is 1 / fan_in (fan_in: the second-to-last dim)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0)
    # 0.8796...: the standard deviation of a unit normal cut at +-2
    std = math.sqrt(1.0 / shape[-2]) / 0.87962566103423978
    return (z * std).to(dtype=dtype, device=device)


def dropout(x, rate: float, train: bool,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout, as ``flax.linen.Dropout``: keep with probability
    1 - rate and scale kept entries by 1 / (1 - rate). The mask comes from
    ``torch.rand(..., generator=generator)``."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` (in, out)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal((in_features, features),
                                                generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y
