"""SVD-based width pruning.

Counterpart of ``pytorch_geometric_tpu/research/pruning.py`` (reference:
ConvexPruning.py ``ContractionLayerCoefficients`` :106-114,
``FindCutoffPoint`` :117-125, ``RetainNetworkSize`` :343-360).

The JAX functions walk a flax parameter pytree; here the same walk runs
over a torch model (:func:`param_items`): each parameter gets its flax
path, ``params/<module>/<leaf>`` (the port's prunable models name their
modules as flax does, ``layers_{i}``, ``out``, ``pool_{i}``, ...), and
the parameters come in ``jax.tree_util``'s order, which sorts the keys
at every level. So ``layers_10`` comes before ``layers_2``, and a
``Dense``'s ``kernel`` (in, out) is named as flax names it. The SVD runs
on the host in numpy, as in the JAX function.
"""

from typing import List, Mapping, Tuple

import numpy as np
import torch


def param_items(params) -> List[Tuple[str, torch.Tensor]]:
    """``(flax path, tensor)`` of every parameter of ``params`` (an
    ``nn.Module``, or a mapping of dotted names to tensors such as its
    ``state_dict``), in ``jax.tree_util``'s order: sorted by the tuple of
    path components, not by the joined string."""
    if isinstance(params, torch.nn.Module):
        named = list(params.named_parameters())
    elif isinstance(params, Mapping):
        named = list(params.items())
    else:
        raise TypeError(f"params must be an nn.Module or a mapping of "
                        f"names to tensors, got {type(params).__name__}")
    keyed = sorted(((("params",) + tuple(name.split(".")), t)
                    for name, t in named), key=lambda item: item[0])
    return [("/".join(path), t) for path, t in keyed]


def _as_2d(t) -> np.ndarray:
    """The host array of ``t``, a ``(1, a, b)`` leaf counted as its
    ``(a, b)`` matrix, as the JAX walk counts it."""
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    if arr.ndim == 3 and arr.shape[0] == 1:
        arr = arr[0]
    return arr


def contraction_layer_coefficients(num_features: int, num_layers: int,
                                   alpha: float, seed: int = 0
                                   ) -> List[int]:
    """Randomly contracted layer widths: each layer's width uniform in
    [alpha * prev, prev) (reference :106-114), drawn with numpy's
    ``default_rng(seed)`` as in the JAX function, so the widths are the
    same."""
    rng = np.random.default_rng(seed)
    widths = []
    prev = int(rng.integers(max(int(num_features * alpha), 1),
                            max(num_features, 2)))
    for _ in range(num_layers):
        new = int(rng.integers(max(int(prev * alpha), 1), max(prev, 2)))
        widths.append(new)
        prev = new
    return widths


def find_cutoff_point(diag_values: np.ndarray, con_coeff: float) -> int:
    """Last index i+1 where sigma_i > con_coeff * sigma_{i+1}; full rank
    if no such gap (reference :117-125, with its quirk: for descending
    singular values the condition holds at every index when
    con_coeff <= 1, so a real contraction needs con_coeff > 1)."""
    diag_values = np.asarray(diag_values)
    cutoff = None
    for i in range(diag_values.shape[0] - 1):
        if diag_values[i] > diag_values[i + 1] * con_coeff:
            cutoff = i + 1
    return cutoff if cutoff is not None else int(diag_values.shape[0])


def retain_network_size(params, con_coeff: float,
                        name_filter: str = "weight") -> List[int]:
    """Per-layer SVD width cutoffs over a model's parameters (reference
    :343-360): one per 2-D parameter whose lower-cased flax path contains
    ``name_filter``, in :func:`param_items` order. Host numpy SVD."""
    out = []
    for name, leaf in param_items(params):
        arr = _as_2d(leaf)
        if arr.ndim != 2 or name_filter not in name.lower():
            continue
        d = np.linalg.svd(arr, compute_uv=False)
        out.append(find_cutoff_point(d, con_coeff))
    return out
