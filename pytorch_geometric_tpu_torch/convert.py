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

- pooling and graph-level models (examples/mutag_gin.py and the rest of
  that family): the ``batch_stats`` collection (``MaskedBatchNorm``'s
  ``mean`` and ``var``) goes into the same state dict as buffers; a flax
  ``OptimizedLSTMCell`` subtree (``ii`` .. ``io`` kernels (in, F),
  ``hi`` .. ``ho`` kernels (F, F) with biases) becomes ``nn.LSTMCell``'s
  ``weight_ih`` = the i, f, g, o kernels side by side, transposed,
  ``weight_hh`` likewise, ``bias_hh`` their biases and ``bias_ih`` 0; a
  flax ``GRUCell`` subtree (``ir``, ``iz``, ``in`` with biases, ``hr``,
  ``hz`` without, ``hn`` with) becomes ``nn.GRUCell``'s ``weight_ih`` /
  ``weight_hh`` (r, z, n), ``bias_ih`` = (b_ir, b_iz, b_in) and
  ``bias_hh`` = (0, 0, b_hn) (``nn/layers.py`` holds the zeros there);
  and ``names`` renames the modules that flax auto-names where the
  port's model keeps them elsewhere (examples/mutag_gin.py's ``MLP_k``
  is the port's ``conv{k+1}.mlp``).
- the point and superpixel examples: examples/mnist_graclus.py's
  ``Net`` (also mnist_voxel_grid's) is ``conv1`` / ``conv2``
  (``SplineConv``, K = 25) and flax's ``Dense_0`` / ``Dense_1``;
  mnist_nn_conv's ``EdgeNN_k`` modules, which flax names in the ``Net``'s
  scope, are the port's ``conv{k+1}.edge_nn`` (``FLAX_NAMES``), and
  inside each the output layer is ``Dense_0`` and the input layer
  ``Dense_1`` (flax numbers the outer call first); pointnet2's ``_mlp``
  layers are flax's ``Dense_0`` .. ``Dense_5`` of the ``Net`` itself,
  the head ``Dense_6`` / ``Dense_7``, and the port's ``Net`` keeps those
  names.
- the prunable zoo (``models/prunable.py``): the modules carry flax's
  names, ``layers_{i}``, ``out``, ``prop_{i}`` (AGNN), ``pool_{i}`` /
  ``proj_{i}`` / ``lin1`` (TopK), each conv with the parameters listed
  above and each ``Dense`` with ``kernel`` (in, out), so the JAX model's
  variables load unchanged whatever the widths, more than ten layers
  included (``layers_10`` is a name like any other).

Only numpy is needed: ``np.asarray`` reads a JAX array without importing
JAX here.
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch


_LSTM = ("i", "f", "g", "o")
_GRU = ("r", "z", "n")


def _f32(a):
    return np.array(a, dtype=np.float32, copy=True)


def _lstm(node):
    """``nn.LSTMCell``'s tensors from a flax ``OptimizedLSTMCell``."""
    w_ih = np.concatenate([_f32(node[f"i{g}"]["kernel"]) for g in _LSTM], 1)
    w_hh = np.concatenate([_f32(node[f"h{g}"]["kernel"]) for g in _LSTM], 1)
    b_hh = np.concatenate([_f32(node[f"h{g}"]["bias"]) for g in _LSTM])
    return {"weight_ih": w_ih.T, "weight_hh": w_hh.T,
            "bias_ih": np.zeros_like(b_hh), "bias_hh": b_hh}


def _gru(node):
    """``nn.GRUCell``'s tensors from a flax ``GRUCell``."""
    w_ih = np.concatenate([_f32(node[f"i{g}"]["kernel"]) for g in _GRU], 1)
    w_hh = np.concatenate([_f32(node[f"h{g}"]["kernel"]) for g in _GRU], 1)
    b_ih = np.concatenate([_f32(node[f"i{g}"]["bias"]) for g in _GRU])
    b_hn = _f32(node["hn"]["bias"])
    zeros = np.zeros(2 * b_hn.shape[0], np.float32)
    return {"weight_ih": w_ih.T, "weight_hh": w_hh.T, "bias_ih": b_ih,
            "bias_hh": np.concatenate([zeros, b_hn])}


_CELLS = {frozenset(f"{s}{g}" for s in "ih" for g in _LSTM): _lstm,
          frozenset(f"{s}{g}" for s in "ih" for g in _GRU): _gru}


def params_from_jax(tree: Mapping,
                    names: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """State dict for the port's model from the JAX model's variables
    (the dict ``model.init`` returns, or its ``["params"]`` entry): nested
    names joined with dots, arrays copied as float32, the
    ``batch_stats`` collection included, flax's LSTM and GRU cells in
    torch's layouts, and each top-level name in ``names`` replaced by its
    value."""
    names = names or {}
    collections = [tree["params"]] if "params" in tree else [tree]
    if "batch_stats" in tree:
        collections.append(tree["batch_stats"])
    out = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            cell = _CELLS.get(frozenset(node))
            items = cell(node).items() if cell else node.items()
            for k, v in items:
                k = names.get(k, k) if not prefix else k
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            out[prefix] = torch.from_numpy(_f32(node))

    for collection in collections:
        walk(collection, "")
    return out
