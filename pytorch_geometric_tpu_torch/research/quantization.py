"""Weight quantization.

Counterpart of ``pytorch_geometric_tpu/research/quantization.py``
(reference: quantization.py ``quantize`` :80, power-of-two level sets
scaled by alpha; ``mapping`` :200, G = alpha * Q; ``ADMM_quantization``
:279; ``direct_quantize`` :455, alpha = mean |W|; ``dorefa_quantize``
:473 and ``dorefa_fw`` :480).

Plain torch elementwise functions on tensors. ``kbits`` follows the
reference's level-count naming (3 => {-1, 0, 1}, 5 => ±{0, 1, 2},
7 => ±{0, 1, 2, 4}, 9 => ±{0, 1, 2, 4, 8}); ``dorefa_*`` take a bit
count.
"""

import torch

from pytorch_geometric_tpu_torch.research.admm import weight_paths

_LEVELS = {3: (1,), 5: (1, 2), 7: (1, 2, 4), 9: (1, 2, 4, 8)}


def quantize(V, alpha, kbits: int = 3):
    """Round V onto the power-of-two level set: the thresholds are the
    midpoints between consecutive levels, times alpha (reference
    :80-180)."""
    if kbits not in _LEVELS:
        raise ValueError(f"kbits must be in {sorted(_LEVELS)}")
    lvls = (0,) + _LEVELS[kbits]
    q = torch.zeros_like(V)
    for i in range(1, len(lvls)):
        lo_mid = (lvls[i - 1] + lvls[i]) / 2.0 * alpha
        q = torch.where(V > lo_mid, float(lvls[i]), q)
        q = torch.where(V < -lo_mid, -float(lvls[i]), q)
    return q


def mapping(Q, alpha):
    return alpha * Q


def direct_quantize(param, kbits: int = 3):
    """alpha = mean |W|; one-shot quantize and map (reference
    :455-471)."""
    alpha = param.abs().mean()
    return mapping(quantize(param, alpha, kbits), alpha)


def dorefa_quantize(param, kbits: int = 8):
    """k-bit uniform rounding in [0, 1] (reference :473-478)."""
    n = float(2 ** kbits - 1)
    return torch.round(param * n) / n


def dorefa_fw(param, bitW: int = 8):
    """DoReFa forward weight quantization (reference :480-486)."""
    x = torch.tanh(param)
    x = x / x.abs().max() * 0.5 + 0.5
    return 2.0 * dorefa_quantize(x, bitW) - 1.0


def admm_quantization(weight, kbits: int = 3, iters: int = 30):
    """Scaled projection onto the quantized set (the goal of the
    reference's ADMM loop :279-370, without its Hessian weighting):
    ``iters`` rounds of Q <- quantize(W; alpha) and the least-squares
    scale alpha <- |<Q, W> / <Q, Q>|. Returns ``(G, alpha)``."""
    alpha = weight.abs().mean() + 1e-12
    for _ in range(iters):
        Q = quantize(weight, alpha, kbits)
        denom = (Q * Q).sum() + 1e-12
        alpha = ((Q * weight).sum() / denom).abs() + 1e-12
    Q = quantize(weight, alpha, kbits)
    return mapping(Q, alpha), alpha


def quantize_params(params, kbits: int = 3, method: str = "direct"):
    """Quantize every weight of at least two dims (``research/admm.py``'s
    walk) of a model, or its state dict, in place; returns ``params``."""
    fns = {"direct": lambda w: direct_quantize(w, kbits),
           "dorefa": lambda w: dorefa_fw(w, kbits),
           "admm": lambda w: admm_quantization(w, kbits)[0]}
    if method not in fns:
        raise ValueError(method)
    with torch.no_grad():
        for _, w in weight_paths(params):
            if w.ndim >= 2:
                w.copy_(fns[method](w))
    return params
