"""Parameter init helpers (counterpart of
``pytorch_geometric_tpu/nn/inits.py``; reference:
``torch_geometric.nn.inits.uniform/glorot/zeros``).

Each takes an explicit ``torch.Generator``: the port draws no numbers
from torch's global generator. The draws differ from ``jax.random``'s
for the same seed, so tests carry weights across with
``convert.params_from_jax``.
"""

import math

import torch


def _uniform(shape, bound, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2 * bound) - bound


def uniform(size: int):
    """PyG's fan-based uniform: an initializer drawing from
    U(-1/sqrt(size), 1/sqrt(size)), with the signature of the others."""
    bound = 1.0 / math.sqrt(size) if size > 0 else 0.0

    def init(shape, generator=None, dtype=torch.float32, device=None):
        return _uniform(shape, bound, generator, dtype, device)

    return init


def glorot(shape, generator=None, dtype=torch.float32, device=None):
    """Glorot/Xavier uniform over the last two dims (PyG semantics:
    bound = sqrt(6 / (fan_in + fan_out)))."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(shape, bound, generator, dtype, device)


def zeros(shape, generator=None, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, generator=None, dtype=torch.float32, device=None):
    return torch.ones(shape, dtype=dtype, device=device)


def kaiming_uniform(shape, generator=None, dtype=torch.float32, device=None,
                    fan=None, a=math.sqrt(5)):
    """Kaiming uniform with leaky-relu slope ``a`` over ``fan`` (default
    the second-to-last dim): bound = sqrt(2 / (1 + a^2)) sqrt(3 / fan)."""
    fan = fan if fan is not None else shape[-2]
    gain = math.sqrt(2.0 / (1 + a ** 2))
    return _uniform(shape, gain * math.sqrt(3.0 / fan), generator, dtype,
                    device)
