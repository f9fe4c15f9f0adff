"""SGD with algebraic-connectivity (Fiedler) regularisation.

Counterpart of ``pytorch_geometric_tpu/research/fiedler_sgd.py``
(reference: sgd.py, ``AlgebraicConnectivity`` :6-12 and an ``SGD.step``
whose weight-decay term is replaced by the Fiedler penalty's gradient,
:74-119).

The JAX package returns an optax transformation; here
:func:`fiedler_sgd` returns the ``torch.optim.Optimizer`` itself. Per
step, each 2-D parameter of at least ``min_dim`` rows and columns gets
``fiedler_coeff * d(-lambda_2)/dW`` added to its gradient (autograd
through ``torch.linalg.eigh``, as ``jax.grad`` through
``jnp.linalg.eigh``), then optax's ``trace`` momentum (``t = g + decay *
t``; with ``nesterov``, ``g + decay * t``) and the update ``-lr * u``.
"""

import torch


def algebraic_connectivity(weight: torch.Tensor):
    """lambda_2 and the Fiedler vector of the Laplacian of the bipartite
    graph of |W|, block adjacency [[0, |W|], [|W|^T, 0]] (reference
    sgd.py:6-12)."""
    M, N = weight.shape
    aw = weight.abs()
    deg = torch.cat([aw.sum(1), aw.sum(0)])
    adj = torch.cat([torch.cat([aw.new_zeros((M, M)), aw], 1),
                     torch.cat([aw.T, aw.new_zeros((N, N))], 1)], 0)
    lap = torch.diag(deg) - adj
    w, v = torch.linalg.eigh(lap)
    return w[1], v[:, 1]


def _fiedler_penalty_grad(p: torch.Tensor) -> torch.Tensor:
    """d(-lambda_2)/dW at ``p``: maximising connectivity."""
    with torch.enable_grad():
        w = p.detach().requires_grad_(True)
        lam2, _ = algebraic_connectivity(w)
        (grad,) = torch.autograd.grad(-lam2, w)
    return grad


class FiedlerSGD(torch.optim.Optimizer):
    """SGD with the Fiedler regulariser in place of weight decay; see
    :func:`fiedler_sgd`. The momentum is ``state[p]["trace"]``."""

    def __init__(self, params, learning_rate: float,
                 fiedler_coeff: float = 1e-4, momentum: float = 0.9,
                 nesterov: bool = False, min_dim: int = 2):
        super().__init__(params, dict(lr=learning_rate,
                                      fiedler_coeff=fiedler_coeff,
                                      momentum=momentum, nesterov=nesterov,
                                      min_dim=min_dim))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, coeff = group["lr"], group["fiedler_coeff"]
            decay, min_dim = group["momentum"], group["min_dim"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if coeff and p.ndim == 2 and min(p.shape) >= min_dim:
                    g = g + coeff * _fiedler_penalty_grad(p)
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = g + decay * state["trace"]
                state["trace"] = trace
                u = g + decay * trace if group["nesterov"] else trace
                p.add_(-lr * u)
        return loss


def fiedler_sgd(params, learning_rate: float, fiedler_coeff: float = 1e-4,
                momentum: float = 0.9, nesterov: bool = False,
                min_dim: int = 2) -> FiedlerSGD:
    """SGD over ``params`` where weight decay is replaced by the Fiedler
    regulariser on every 2-D weight (reference sgd.py:95-105; the JAX
    ``fiedler_sgd(learning_rate, ...)`` returns an optax
    transformation)."""
    return FiedlerSGD(params, learning_rate, fiedler_coeff, momentum,
                      nesterov, min_dim)
