"""Standalone resumable GCN: the port's counterpart of examples/mygcn.py
(reference examples/MyGCN.py:39-47). The 2-layer GCN of examples/gcn.py
trained in spans of ``span`` epochs through ``create_gcn_train_step``
(its packed backend); after each span one evaluation and a checkpoint on
the best validation accuracy (``research/checkpoint.py``); ``--resume``
restores the net, Adam's state, the loss history and the epoch counter,
then trains on from there.

The JAX script runs each span as one jitted ``lax.scan`` of the epoch.
Here, on a card, the epoch is a CUDA graph captured once and replayed
``span`` times a span (``models/capture.py:EpochSpans``,
``capture=None`` or ``True``), the dropout drawn inside it from the
generator registered with it; the evaluation and the checkpoint run
between the spans. ``--resume`` loads the checkpoint before the first
epoch, into the model's own parameters (``load_state_dict`` copies in
place) and Adam's state, so the capture reads what was restored.
``capture=False`` runs the same epochs from Python (the CPU's only
mode).

    python -m pytorch_geometric_tpu_torch.examples.mygcn [--epochs 60] \\
        [--resume]

Prints the JAX script's line after each span. The dropout generator
starts from ``seed`` on every run, resumed or not, as the JAX key does.
"""

import argparse

import torch

from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.examples.gcn import load
from pytorch_geometric_tpu_torch.models.capture import (
    EpochSpans, resolve_capture)
from pytorch_geometric_tpu_torch.models.citation import (
    GCN, create_gcn_train_step)
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager


def run(dataset: str = "Cora", epochs: int = 60, resume: bool = False,
        seed: int = 0, ckpt_dir: str = "checkpoint", span: int = 20,
        device="cuda", capture=None):
    """Train to ``epochs`` and return the final accuracies (device
    scalars), the loss history, the model, its ``EpochSpans``
    (``spans``) and what ``EpochSpans.metrics`` gives. ``capture`` (see
    the module docstring) None means captured on a card and eager on the
    CPU; True elsewhere than a card raises."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    ds, graph = load(dataset, device=dev)
    model = GCN(graph.num_node_features, 16, ds.num_classes,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    epoch_step, eval_fn = create_gcn_train_step(model, graph)
    opt = epoch_step.optimizer
    gen = torch.Generator(device=dev).manual_seed(seed)
    ckpt = CheckpointManager(ckpt_dir)
    run_key = f"mygcn-{dataset}"

    start_epoch = 0
    history = []
    if resume:
        restored = ckpt.resume(run_key)
        if restored is not None:
            params, opt_state, train_conv, _, metric, ep = restored
            model.load_state_dict(params)
            opt.load_state_dict(opt_state)
            history = list(train_conv or [])
            start_epoch = int(ep or 0)
            print(f"=> resumed from epoch {start_epoch} "
                  f"(best val {metric:.4f})")

    spans = EpochSpans(lambda: epoch_step(gen)["loss"],
                       max(epochs - start_epoch, 0), dev, capture, gen)
    epoch = start_epoch
    while epoch < epochs:
        length = min(span, epochs - epoch)
        history.extend(spans.span(length)[:, 0].tolist())
        epoch += length
        ev = spans.between(lambda: {k: float(v)
                                    for k, v in eval_fn().items()})
        spans.between(ckpt.save_best, run_key, ev["val_acc"],
                      model.state_dict(), opt.state_dict(), history,
                      [ev["test_acc"]], epoch=epoch)
        print(f"Epoch {epoch:03d}  loss {history[-1]:.4f}  "
              f"val {ev['val_acc']:.4f}  test {ev['test_acc']:.4f}")
    return {**spans.between(eval_fn), "history": history, "model": model,
            "spans": spans, **spans.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="Cora")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--resume", "-r", action="store_true")
    args = p.parse_args()
    run(args.dataset, args.epochs, args.resume)
