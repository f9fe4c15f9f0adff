"""ADMM pruning machinery.

Counterpart of ``pytorch_geometric_tpu/research/admm.py`` (reference:
utils.py ``admm_loss`` :17, ``initialize_Z_and_U`` :28, ``update_X``
:39, ``update_Z`` :47 (percentile projection), ``update_Z_l1`` :60 (soft
threshold), ``update_U`` :76, ``apply_prune`` / ``prune_weight``
:85-113, ``print_prune`` :140).

"The weights" are the parameters whose flax path ends in ``weight`` or
``kernel`` (``research/pruning.py:param_items``, the JAX order). Where
the JAX functions take and return pytrees with None at the other leaves,
these take a model (or its state dict) and keep ``X``, ``Z``, ``U`` and
the masks as dicts ``{flax path: tensor}`` over the weights, in that
order. ``apply_prune`` and ``apply_masks`` edit the parameters in place.
The percentiles run on the host in numpy, as in the reference.
"""

from typing import Dict

import numpy as np
import torch

from pytorch_geometric_tpu_torch.research.pruning import param_items


def _is_weight(path: str) -> bool:
    last = path.split("/")[-1].lower()
    return last in ("weight", "kernel") or last.endswith("weight")


def weight_paths(params):
    """``[(flax path, tensor)]`` of the weights."""
    return [(p, leaf) for p, leaf in param_items(params) if _is_weight(p)]


def select_weights(params):
    """``{flax path: tensor or None}`` over every parameter: the weights
    kept, the others None."""
    return {p: (leaf if _is_weight(p) else None)
            for p, leaf in param_items(params)}


def initialize_Z_and_U(params):
    """``(Z, U)``: Z a copy of each weight, U zeros."""
    ws = weight_paths(params)
    Z = {p: w.detach().clone() for p, w in ws}
    U = {p: torch.zeros_like(w) for p, w in ws}
    return Z, U


def admm_loss(base_loss, params, Z, U, rho: float, alpha: float = 0.0,
              l2: bool = False):
    """base_loss + rho/2 ||W - Z + U|| per weight (the reference's norm,
    not its square), + alpha ||W|| each with ``l2``; differentiable in
    the model's weights."""
    total = base_loss
    for path, w in weight_paths(params):
        z = Z.get(path)
        if z is None:
            continue
        total = total + rho / 2 * torch.linalg.vector_norm(
            (w - z + U[path]).reshape(-1))
        if l2:
            total = total + alpha * torch.linalg.vector_norm(w.reshape(-1))
    return total


def update_X(params):
    """A detached copy of each weight."""
    return {p: w.detach().clone() for p, w in weight_paths(params)}


def update_Z(X, U, percent):
    """Percentile hard-threshold projection of X + U (host percentile,
    reference :47-57). ``percent`` is a scalar, or one per weight in
    order."""
    percents = percent if isinstance(percent, (list, tuple)) else None
    out = {}
    for i, (path, x) in enumerate(X.items()):
        z = (x + U[path]).cpu().numpy().copy()
        p = percents[i] if percents else percent
        pcen = np.percentile(np.abs(z), 100 * p)
        z[np.abs(z) < pcen] = 0
        out[path] = torch.from_numpy(z).to(x.device)
    return out


def update_Z_l1(X, U, alpha: float, rho: float):
    """Soft-threshold (L1 proximal) projection (reference :60-73)."""
    delta = alpha / rho
    out = {}
    for path, x in X.items():
        z = x + U[path]
        out[path] = torch.where(z > delta, z - delta,
                                torch.where(z < -delta, z + delta, 0.0))
    return out


def update_U(U, X, Z):
    return {path: u + X[path] - Z[path] for path, u in U.items()}


def apply_prune(params, percent):
    """Hard percentile pruning of every weight, in place; returns
    ``(params, masks)`` with ``masks`` ``{flax path: 0/1 mask}``
    (reference :85-113)."""
    percents = percent if isinstance(percent, (list, tuple)) else None
    masks = {}
    with torch.no_grad():
        for i, (path, w) in enumerate(weight_paths(params)):
            p = percents[i] if percents else percent
            wn = w.detach().cpu().numpy()
            pcen = np.percentile(np.abs(wn), 100 * p)
            mask = torch.from_numpy(
                (np.abs(wn) >= pcen).astype(wn.dtype)).to(w.device)
            masks[path] = mask
            w.mul_(mask)
    return params, masks


def apply_masks(params, masks: Dict[str, torch.Tensor]):
    """Re-apply saved masks after a gradient step (masked retraining),
    in place."""
    with torch.no_grad():
        for path, w in param_items(params):
            if path in masks:
                w.mul_(masks[path])
    return params


def print_prune(params) -> float:
    """Report sparsity; returns the overall pruned fraction (reference
    :140-152)."""
    pruned = total = 0
    for path, w in weight_paths(params):
        wn = w.detach().cpu().numpy()
        nz = int((wn != 0).sum())
        print(f"[{path}] pruned {100 * (wn.size - nz) / wn.size:.2f}% "
              f"({nz}/{wn.size} nonzero)")
        pruned += wn.size - nz
        total += wn.size
    frac = pruned / max(total, 1)
    print(f"total pruned: {pruned}/{total} ({100 * frac:.2f}%)")
    return frac
