"""Best-metric checkpoint / resume.

Counterpart of ``pytorch_geometric_tpu/research/checkpoint.py``
(reference: ConvexPruning.py's checkpoint of {net_state_dict,
optimizer_state_dict, TrainConvergence, TestConvergence, TestAcc},
written only on a best-metric improvement, :78-88, reloaded by
``ResumeModel``, :362-371; examples/MyGCN.py:39-47 also restores the
epoch counter).

The same save-on-best rule and the same payload fields, written with
``torch.save`` to ``{run_key}-ckpt.pt`` through a ``.tmp`` file and
``os.replace``, and read back with ``torch.load(weights_only=True)``:
state dicts (a model's, an optimizer's), lists, numbers and strings
only, and no pickle is ever read unsafely. The tensors are saved on the
CPU. The JAX package's ``.pkl`` checkpoints are not read.
"""

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch


def _to_cpu(tree):
    """``tree`` (a state dict, an optimizer's state dict, lists, numbers)
    with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Save-on-best checkpointing keyed by run name."""

    def __init__(self, directory: str = "checkpoint"):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, run_key: str) -> str:
        return osp.join(self.directory, f"{run_key}-ckpt.pt")

    def save_best(self, run_key: str, metric: float, params, opt_state,
                  train_convergence=None, test_convergence=None,
                  epoch: int = 0, extra: Optional[Dict[str, Any]] = None
                  ) -> bool:
        """Write iff ``metric`` beats the stored best (higher is better,
        like the reference's accuracy criterion). ``params`` is a model's
        state dict, ``opt_state`` its optimizer's. Returns whether it
        wrote."""
        prev = self.load(run_key)
        if prev is not None and prev["metric"] >= metric:
            return False
        payload = {
            "metric": float(metric),
            "epoch": int(epoch),
            "params": _to_cpu(params),
            "opt_state": _to_cpu(opt_state),
            "train_convergence": [float(v) for v in
                                  (train_convergence or [])],
            "test_convergence": [float(v) for v in
                                 (test_convergence or [])],
            "extra": _to_cpu(extra or {}),
        }
        tmp = self.path(run_key) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(run_key))
        return True

    def load(self, run_key: str) -> Optional[Dict[str, Any]]:
        p = self.path(run_key)
        if not osp.exists(p):
            return None
        return torch.load(p, map_location="cpu", weights_only=True)

    def resume(self, run_key: str):
        """``(params, opt_state, train_conv, test_conv, metric, epoch)``
        or None (reference ResumeModel, ConvexPruning.py:362-371):
        ``params`` for ``model.load_state_dict``, ``opt_state`` for the
        optimizer's ``load_state_dict``, both on the CPU (each copies
        them to its own device)."""
        ck = self.load(run_key)
        if ck is None:
            return None
        return (ck["params"], ck["opt_state"], ck["train_convergence"],
                ck["test_convergence"], ck["metric"], ck["epoch"])
