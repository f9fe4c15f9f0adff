"""Carry parameters from the JAX package to the port.

The JAX GCN keeps its parameters as a nested dict,
``params["params"]["conv1"]["weight"]`` (in, out) and ``["bias"]``
(out,); the port's ``GCN`` state dict names the same arrays
``conv1.weight`` and ``conv1.bias``, in the same layouts. Only numpy is
needed: ``np.asarray`` reads a JAX array without importing JAX here.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def gcn_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``GCN`` from the JAX GCN's params (the
    dict ``model.init`` returns, or its ``["params"]`` entry)."""
    params = tree["params"] if "params" in tree else tree
    out = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))

    walk(params, "")
    return out
