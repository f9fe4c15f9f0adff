"""Parameter init helpers (counterpart of
``pytorch_geometric_tpu/nn/inits.py``; reference:
``torch_geometric.nn.inits.glorot/zeros``).

Each takes an explicit ``torch.Generator``: the port draws no numbers
from torch's global generator. The draws differ from ``jax.random``'s
for the same seed, so tests carry weights across with
``convert.params_from_jax``.
"""

import math

import torch


def glorot(shape, generator=None, dtype=torch.float32, device=None):
    """Glorot/Xavier uniform over the last two dims (PyG semantics:
    bound = sqrt(6 / (fan_in + fan_out)))."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2 * bound) - bound


def zeros(shape, generator=None, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)
