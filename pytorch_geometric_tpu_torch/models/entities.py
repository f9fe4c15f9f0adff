"""Entity classification on relational graphs: the RGCN of
examples/rgcn.py, trained full-graph through the fused operator.

The JAX package keeps this loop in ``examples/rgcn.py`` and
``bench_common.py:bench_rgcn_fullgraph``; the port gives it a module, as
``models/citation.py`` holds the GAT example's:

- :class:`RGCN`: the example's ``Net``: ``RGCNConv(N, 16, R, num_bases=
  30)`` on node-id embeddings (``x=None``), ReLU, ``RGCNConv(16, classes,
  R, num_bases=30)``; parameters ``conv1.basis``, ``conv1.att``,
  ``conv1.root``, ``conv1.bias``, ``conv2.*``.
- :func:`rgcn_fused_ops`: one fused aggregation operator per layer
  (``nn/conv/rgcn_conv.py:rgcn_fused_op``); on a CUDA graph every
  aggregation runs the hand-written kernels of ``ops/packed_rgcn.py``:
  per epoch 2 forward launches and 6 backward launches (3 per layer).
- :func:`train_rgcn`: Adam (lr 0.01) on the mean cross-entropy over the
  training entities, the epochs captured in one CUDA graph on a CUDA
  device (``models/capture.py``), eager on the CPU. ``closure=True``
  trains on the training entities' two-layer receptive field
  (``data/closure.py``; ``bench_common.py:bench_rgcn``): each layer one
  rectangular ``PackedRgcnSpmm`` over its closure edges
  (``nn/conv/rgcn_conv.py:rgcn_closure_op``), the same kernels; the
  evaluation stays on the full graph.

The JAX bench first reorders the nodes (RCM) to fill the TPU's window
buckets: a CSR kernel has no use for it, and a node permutation changes
no result. Its full-graph row keeps Adam's moments in bf16
(``utils/optim.py:adam_compact``, which the port has); ``train_rgcn``
trains with ``torch.optim.Adam``, as examples/rgcn.py does, and
``chip_smoke.py`` runs the captured epoch with both.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.closure import (
    layered_training_closure)
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    resolve_capture, run_epochs)
from pytorch_geometric_tpu_torch.models.citation import (
    softmax_xent_int_labels)
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import (
    RGCNConv, rgcn_closure_op, rgcn_fused_op, rgcn_norm)


class RGCN(nn.Module):
    """2-layer RGCN over node-id embeddings (examples/rgcn.py ``Net``)."""

    def __init__(self, num_nodes: int, num_relations: int, num_classes: int,
                 hidden: int = 16, num_bases: int = 30,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = RGCNConv(num_nodes, hidden, num_relations,
                              num_bases=num_bases, generator=generator)
        self.conv2 = RGCNConv(hidden, num_classes, num_relations,
                              num_bases=num_bases, generator=generator)

    def forward(self, graph: Graph, edge_type=None, norm=None,
                fused_ops=None, closure=None, norms=None):
        """``fused_ops``: the pair of :func:`rgcn_fused_ops` (with
        ``closure``, of :func:`rgcn_closure_ops`), or None for the plain
        paths (which take ``norm``, a precomputed ``rgcn_norm``, or with
        ``closure`` (the two ``ClosureLayer``s) ``norms``, their
        ``rgcn_closure_norm``; on a CPU tensor only). With ``closure`` the
        rows are the last layer's output nodes, the seeds first."""
        op1, op2 = fused_ops if fused_ops is not None else (None, None)
        if closure is not None:
            n1, n2 = norms if norms is not None else (None, None)
            x = torch.relu(self.conv1(None, None, norm=n1, fused_op=op1,
                                      closure=closure[0]))
            return self.conv2(None, x, norm=n2, fused_op=op2,
                              closure=closure[1])
        x = self.conv1(graph, None, edge_type, norm=norm, fused_op=op1)
        x = torch.relu(x)
        return self.conv2(graph, x, edge_type, norm=norm, fused_op=op2)


def rgcn_fused_ops(graph: Graph, num_relations: int):
    """The fused operators of :class:`RGCN`'s two layers on the graph's
    device: ``embed`` mode for conv1 (its source rows are the embedding
    table's, one per node) and ``transform`` mode for conv2, sharing one
    ``rgcn_norm``."""
    et = graph.edge_type
    norm = rgcn_norm(graph, et, num_relations)
    return (rgcn_fused_op(graph, et, num_relations, "embed",
                          in_channels=graph.num_nodes, norm=norm),
            rgcn_fused_op(graph, et, num_relations, "transform", norm=norm))


def rgcn_closure(graph: Graph, seeds, num_layers: int = 2):
    """The ``num_layers`` closure layers of ``seeds`` over the graph's
    real typed edges, on the graph's device."""
    real = graph.real_edge_mask().cpu().numpy()
    ei = np.stack([graph.senders.cpu().numpy()[real],
                   graph.receivers.cpu().numpy()[real]])
    return layered_training_closure(
        ei, host_array(seeds), num_layers, num_nodes=graph.num_nodes,
        edge_type=graph.edge_type.cpu().numpy()[real], device=graph.device)


def rgcn_closure_ops(layers, num_nodes: int, num_relations: int):
    """The fused operators of :class:`RGCN`'s two closure layers:
    ``embed`` mode for conv1 (global senders over the ``num_nodes`` rows
    of the embedding table) and ``transform`` mode for conv2, with their
    ``rgcn_closure_norm`` baked in."""
    return (rgcn_closure_op(layers[0], num_relations, "embed",
                            in_channels=num_nodes),
            rgcn_closure_op(layers[1], num_relations, "transform"))


def _split_indices(graph: Graph, name: str):
    """Entity indices of one split (``train_idx`` / ``test_idx``) as an
    int64 tensor: the collation stacks them per graph, and row 0 is the
    one real graph's."""
    return graph.extras[name][0].long()


def create_rgcn_train_step(model: RGCN, graph: Graph, num_relations: int,
                           lr: float = 0.01, closure: bool = False):
    """Build ``(epoch_step, eval_fn)`` closures over a static graph, as
    ``models/citation.py:create_gat_train_step``. Every aggregation runs
    through :func:`rgcn_fused_ops` (the kernels on a CUDA graph). The loss is the mean cross-entropy over the
    graph's ``train_idx``; labels of -1 (unlabelled entities) are never
    indexed.

    ``torch.optim.Adam`` and ``optax.adam`` share b1, b2 and eps (added
    outside the square root). As in ``create_gcn_train_step``, on a CUDA
    graph Adam is built with ``capturable=True`` and the gradients are
    zeroed in place, so a CUDA graph can hold the step.

    ``closure=True`` trains on the training entities' closure
    (:func:`rgcn_closure`, its operators :func:`rgcn_closure_ops`, all
    built here, before any epoch): the loss reads the last layer's first
    rows, the seeds in ``train_idx`` order. The evaluation stays on the
    full graph.
    """
    fused_ops = rgcn_fused_ops(graph, num_relations)
    train_idx = _split_indices(graph, "train_idx")
    test_idx = _split_indices(graph, "test_idx")
    y_train, y_test = graph.y[train_idx].long(), graph.y[test_idx].long()
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           capturable=graph.device.type == "cuda")
    n_train = train_idx.shape[0]
    if closure:
        layers = rgcn_closure(graph, train_idx)
        closure_ops = rgcn_closure_ops(layers, graph.num_nodes,
                                       num_relations)

        def train_logits():
            return model(None, fused_ops=closure_ops,
                         closure=layers)[:n_train]
    else:
        def train_logits():
            return model(graph, fused_ops=fused_ops)[train_idx]

    def epoch_step(generator: Optional[torch.Generator] = None):
        # no dropout in this model: the generator draws nothing
        model.train()
        opt.zero_grad(set_to_none=False)
        logits = train_logits()
        loss = softmax_xent_int_labels(logits, y_train).mean()
        loss.backward()
        opt.step()
        return {"loss": loss.detach(),
                "train_acc": _accuracy(logits.detach(), y_train)}

    @torch.no_grad()
    def eval_fn():
        model.eval()
        logits = model(graph, fused_ops=fused_ops)
        return {"train_acc": _accuracy(logits[train_idx], y_train),
                "test_acc": _accuracy(logits[test_idx], y_test)}

    return epoch_step, eval_fn


def train_rgcn(graph: Graph, num_relations: int, num_classes: int,
               epochs: int = 50, seed: int = 0, lr: float = 0.01,
               device="cuda", capture: Optional[bool] = None,
               closure: bool = False) -> Tuple[RGCN, Dict[str, Any]]:
    """Full RGCN training run on ``device``, as examples/rgcn.py ``run``
    through the fused operators: ``epochs`` Adam steps, then one
    evaluation, captured or not as ``capture`` says (as ``train_gcn``).
    Returns the model and its metrics: final ``train_acc`` / ``test_acc``
    (the corpus has no validation split), the per-epoch ``curve`` (numpy
    arrays of ``loss`` and ``train_acc``) and ``seconds``, as
    ``train_gat`` (a captured run adds ``capture_seconds`` and
    ``launches``). The splits are the graph's ``train_idx`` /
    ``test_idx``. On a CUDA graph the forward's kernels launch 4 times
    per epoch and 4 for the evaluation (2 a layer), the backward's 6
    times per epoch (3 a layer), ``closure=True`` or not (the closure's
    layers run the same kernels over their own edges)."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    graph = graph.to(dev)
    model = RGCN(graph.num_nodes, num_relations, num_classes,
                 generator=torch.Generator().manual_seed(seed)).to(dev)
    epoch_step, eval_fn = create_rgcn_train_step(
        model, graph, num_relations, lr=lr, closure=closure)
    return model, run_epochs(epoch_step, eval_fn, epochs, None, dev,
                             capture)


def _accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()
