"""Adam with compact moments.

Counterpart of ``pytorch_geometric_tpu/utils/optim.py``.
:func:`adam_compact` stores both moments in ``moment_dtype`` (bf16 by
default) and computes in fp32, as the JAX optimizer does: the step is
taken from the unrounded fp32 moments, which are then stored rounded.

It is a ``torch.optim.Optimizer`` that a CUDA graph can hold: the step
count lives in an int32 tensor on the parameters' device
(``param_groups[i]["count"]``), and the bias corrections are computed
there, so a step waits on nothing from the host. The moments are
``state[p]["mu"]`` and ``state[p]["nu"]``. The update is plain torch
elementwise operations (the JAX package leaves it to XLA, outside any
Pallas kernel). It halves the moments' bytes but makes more passes than
``torch.optim.Adam(capturable=True)``'s foreach update: on the captured
MUTAG-RDF RGCN epoch (11.3 M parameters, chip_smoke.py's
``adam_compact`` phase, NVIDIA H100 80GB HBM3 at 700 W) its step took
930.9 µs against Adam's 413.6 µs. It saves memory, not time, until its
update is fused.
"""

import torch


class CompactAdam(torch.optim.Optimizer):
    """Adam with both moments stored in ``moment_dtype``; see
    :func:`adam_compact`."""

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=learning_rate, b1=b1, b2=b2,
                                      eps=eps, moment_dtype=moment_dtype))
        for group in self.param_groups:
            device = group["params"][0].device
            group["count"] = torch.zeros((), dtype=torch.int32,
                                         device=device)
            for p in group["params"]:
                self.state[p]["mu"] = torch.zeros_like(
                    p, dtype=moment_dtype, memory_format=torch.preserve_format)
                self.state[p]["nu"] = torch.zeros_like(
                    p, dtype=moment_dtype, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            count = group["count"]
            count.add_(1)
            c = count.float()
            bc1 = 1.0 - torch.pow(b1, c)
            bc2 = 1.0 - torch.pow(b2, c)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                g = p.grad.float()
                mu_f = b1 * state["mu"].float() + (1 - b1) * g
                nu_f = b2 * state["nu"].float() + (1 - b2) * g * g
                step = (-lr * (mu_f / bc1)) / (torch.sqrt(nu_f / bc2) + eps)
                p.add_(step.to(p.dtype))
                state["mu"].copy_(mu_f)
                state["nu"].copy_(nu_f)
        return loss


def adam_compact(params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype=torch.bfloat16) -> CompactAdam:
    """Adam over ``params`` with both moments stored in ``moment_dtype``
    (the JAX ``adam_compact(learning_rate, ...)``, which returns an optax
    transformation; here the optimizer itself). ``b1``, ``b2`` and
    ``eps`` are optax's (eps outside the square root)."""
    return CompactAdam(params, learning_rate, b1, b2, eps, moment_dtype)
