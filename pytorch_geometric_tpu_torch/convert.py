"""Carry parameters from the JAX package to the port.

The JAX models keep their parameters as a nested dict,
``params["params"]["conv1"]["weight"]``; the port's modules name the same
arrays ``conv1.weight``, in the same layouts:

- GCN: ``convK.weight`` (in, out) and ``convK.bias`` (out,);
- GAT (examples/gat.py): ``convK.weight`` (in, H*C), ``convK.att_src``
  and ``convK.att_dst`` (1, H, C), ``convK.bias`` (H*C,) or (C,); the
  same parameters whichever fused operator aggregates (``backend=
  "packed"``, ``"dense"`` or ``"bsr"``) and whatever the graph: the
  PubMed model (500 -> 8 x 8 -> 3) has conv1.weight (500, 64) and
  conv2.weight (64, 3), so no operator adds a layout here;
- RGCN (examples/rgcn.py): ``convK.basis`` (B, F_in, C) (B = R without
  bases), ``convK.att`` (R, B) (only with bases), ``convK.root``
  (F_in, C), ``convK.bias`` (C,);
- FAUST (examples/faust.py): six ``SplineConv`` layers ``conv1`` ..
  ``conv6`` with ``weight`` (K, F_in, C) (K = 125), ``root`` (F_in, C)
  and ``bias`` (C,), whichever operator aggregates (the rectangular
  ``spline_operator`` or the K square ``spline_operators``), and flax's
  auto-named ``Dense_0`` / ``Dense_1`` with ``kernel`` (in, out) and
  ``bias``.

Only numpy is needed: ``np.asarray`` reads a JAX array without importing
JAX here.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's model from the JAX model's params (the
    dict ``model.init`` returns, or its ``["params"]`` entry): nested
    names joined with dots, arrays copied as float32."""
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

