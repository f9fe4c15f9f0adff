"""The port's counterparts of the ``flax.linen`` layers that the JAX
package's models and examples use:

- :class:`Dense`: ``kernel`` is (in, out), as in flax, so
  ``y = x @ kernel + bias`` and ``convert.params_from_jax`` carries a
  flax ``Dense``'s parameters across unchanged. The kernel is drawn as
  flax's default ``lecun_normal``: a normal of variance 1 / fan_in
  truncated at two standard deviations.
- :func:`dropout`: ``flax.linen.Dropout``'s inverted dropout, with the
  mask drawn from the caller's generator.
- :func:`lstm_cell`, :func:`gru_cell`: ``torch.nn.LSTMCell`` /
  ``GRUCell`` for flax's ``OptimizedLSTMCell`` / ``GRUCell`` (Set2Set,
  examples/qm9_nn_conv.py), drawn from the caller's generator; their
  layouts map onto flax's (``convert.params_from_jax``). Flax has one
  bias a gate where torch has two (``b_ih + b_hh``), so the copy flax
  lacks is held at 0 and takes no gradient: the LSTM's ``bias_ih`` and
  the GRU's ``bias_hh`` of its r and z gates (flax's ``hr`` and ``hz``
  have no bias). An optimizer then moves each gate's bias as flax's.
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


def _cell(cls, input_size: int, hidden_size: int, generator):
    """``cls`` (``nn.LSTMCell`` or ``nn.GRUCell``) with its weights drawn
    from ``generator`` as torch draws them, U(-1/sqrt(H), 1/sqrt(H)),
    not from torch's global generator."""
    cell = cls(input_size, hidden_size, device="meta").to_empty(
        device="cpu")
    bound = 1.0 / math.sqrt(hidden_size)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                    - bound)
    return cell


def lstm_cell(input_size: int, hidden_size: int,
              generator: Optional[torch.Generator] = None) -> nn.LSTMCell:
    """``nn.LSTMCell`` drawn from ``generator``, ``bias_ih`` held at 0;
    call it ``cell(x, (h, c))``, flax's ``cell((c, h), x)``."""
    cell = _cell(nn.LSTMCell, input_size, hidden_size, generator)
    with torch.no_grad():
        cell.bias_ih.zero_()
    cell.bias_ih.requires_grad_(False)
    return cell


def gru_cell(input_size: int, hidden_size: int,
             generator: Optional[torch.Generator] = None) -> nn.GRUCell:
    """``nn.GRUCell`` drawn from ``generator``, the r and z thirds of
    ``bias_hh`` held at 0; call it ``cell(x, h)``, flax's
    ``cell(h, x)``."""
    cell = _cell(nn.GRUCell, input_size, hidden_size, generator)
    keep = torch.ones(3 * hidden_size)
    keep[:2 * hidden_size] = 0.0
    with torch.no_grad():
        cell.bias_hh.mul_(keep)
    # a buffer, so that it moves with the cell
    cell.register_buffer("bias_hh_keep", keep, persistent=False)
    cell.bias_hh.register_hook(lambda g: g * cell.bias_hh_keep)
    return cell
