"""Citation-network models: the reference's canonical workload.

Counterpart of ``pytorch_geometric_tpu/models/citation.py``: a 2-layer
GCN (hidden 16, dropout 0.5, Adam lr 0.01, weight decay 5e-4 on the first
layer only), trained full-batch on Cora for 200 epochs (reference
examples/gcn.py:15-40).

The JAX package runs the 200 epochs as one ``lax.scan`` program; here the
loop runs eagerly, one ``epoch_step`` per epoch, and nothing is copied to
the host until the run ends. Every aggregation, forward and backward,
goes through ``SpmmOperator.bind`` over the self-looped ``gcn_norm``
edge set without its padding edges (:func:`gcn_spmm_operator`, the
counterpart of the JAX ``pallas=True`` configuration): on
a CUDA graph that is the hand-written CSR kernel, 4 launches per epoch
(2 forward, 2 backward); on a CPU graph the kernel's wrapper computes
the same function in plain PyTorch.
"""

import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import GCNConv, gcn_norm
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator


def dropout(x, rate: float, train: bool,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout, as ``flax.linen.Dropout``: keep with probability
    1 - rate and scale kept entries by 1 / (1 - rate). The mask comes from
    ``torch.rand(..., generator=generator)``."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class GCN(nn.Module):
    """2-layer GCN for transductive node classification."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_classes: int, dropout_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = GCNConv(in_channels, hidden_channels,
                             generator=generator)
        self.conv2 = GCNConv(hidden_channels, num_classes,
                             generator=generator)

    def forward(self, graph: Graph, x, norm=None, *, train: bool = False,
                norm_dense=None, aggregate_fn=None,
                generator: Optional[torch.Generator] = None):
        if norm is None and norm_dense is None and aggregate_fn is None:
            norm = gcn_norm(graph)
        x = dropout(x, self.dropout_rate, train, generator)
        x = self.conv1(graph, x, norm=norm, norm_dense=norm_dense,
                       aggregate_fn=aggregate_fn)
        x = torch.relu(x)
        x = dropout(x, self.dropout_rate, train, generator)
        return self.conv2(graph, x, norm=norm, norm_dense=norm_dense,
                          aggregate_fn=aggregate_fn)   # logits


def softmax_xent_int_labels(logits, labels):
    """Per-row negative log-likelihood of integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def masked_softmax_xent(logits, labels, mask):
    nll = softmax_xent_int_labels(logits, labels)
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def masked_accuracy(logits, labels, mask):
    pred = logits.argmax(dim=-1)
    m = mask.to(torch.float32)
    return ((pred == labels.long()) * m).sum() / m.sum().clamp_min(1.0)


def gcn_spmm_operator(graph: Graph) -> Tuple[SpmmOperator, torch.Tensor]:
    """The ``SpmmOperator`` of the GCN aggregation and its static weights:
    the self-looped ``gcn_norm`` edge set with the padding edges left out.
    They weigh 0, so no sum changes; kept, they would all land in the
    padding node's CSR row, and the kernel's time follows its longest
    row. Every self loop stays, padding nodes' included."""
    norm = gcn_norm(graph)
    keep = torch.cat([graph.real_edge_mask(),
                      torch.ones(graph.num_nodes, dtype=torch.bool,
                                 device=graph.device)])
    op = SpmmOperator(norm.senders[keep], norm.receivers[keep],
                      graph.num_nodes, device=graph.device)
    return op, norm.weights[keep]


def create_gcn_train_step(model: GCN, graph: Graph, weight_decay=5e-4,
                          lr=0.01):
    """Build ``(epoch_step, eval_fn)`` closures over a static graph.

    ``epoch_step(generator)`` takes one Adam step and returns the epoch's
    ``{"loss", "train_acc"}`` as device scalars; ``generator`` draws the
    dropout masks. ``eval_fn()`` returns train/val/test accuracy.

    Weight decay is ``weight_decay * sum(p**2)`` over the first layer's
    weight and bias, added to the loss, as in the JAX package (the
    reference's per-group Adam, examples/gcn.py:31-34); it is not
    ``torch.optim.Adam(weight_decay=...)``, which adds ``wd * p`` to the
    gradient of every parameter. ``torch.optim.Adam`` and ``optax.adam``
    share b1, b2 and eps (added outside the square root).
    """
    op, weights = gcn_spmm_operator(graph)
    aggregate_fn = op.bind(weights)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    decayed = list(model.conv1.parameters())

    def epoch_step(generator: Optional[torch.Generator] = None):
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(graph, graph.x, train=True, aggregate_fn=aggregate_fn,
                       generator=generator)
        loss = masked_softmax_xent(logits, graph.y, graph.train_mask)
        loss = loss + weight_decay * sum((p ** 2).sum() for p in decayed)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(),
                "train_acc": masked_accuracy(logits.detach(), graph.y,
                                             graph.train_mask)}

    @torch.no_grad()
    def eval_fn():
        model.eval()
        logits = model(graph, graph.x, aggregate_fn=aggregate_fn)
        return {
            "train_acc": masked_accuracy(logits, graph.y, graph.train_mask),
            "val_acc": masked_accuracy(logits, graph.y, graph.val_mask),
            "test_acc": masked_accuracy(logits, graph.y, graph.test_mask),
        }

    return epoch_step, eval_fn


def train_gcn(graph: Graph, num_classes: int, hidden: int = 16,
              epochs: int = 200, seed: int = 0, lr: float = 0.01,
              device="cuda") -> Tuple[GCN, Dict[str, Any]]:
    """Full training run on ``device``: ``epochs`` Adam steps, then one
    evaluation. Returns the model and its metrics: final
    ``train_acc`` / ``val_acc`` / ``test_acc``, the per-epoch ``curve``
    (numpy arrays of ``loss`` and ``train_acc``), and ``seconds``, the
    wall time of the epochs and the evaluation (after the operator's host
    set-up, ending in a device synchronisation)."""
    dev = resolve_device(device)
    graph = graph.to(dev)
    init_gen = torch.Generator().manual_seed(seed)
    model = GCN(graph.num_node_features, hidden, num_classes,
                generator=init_gen).to(dev)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    epoch_step, eval_fn = create_gcn_train_step(model, graph, lr=lr)

    _synchronize(dev)
    t0 = time.perf_counter()
    curve = [epoch_step(drop_gen) for _ in range(epochs)]
    final = eval_fn()
    _synchronize(dev)
    seconds = time.perf_counter() - t0

    metrics: Dict[str, Any] = {k: float(v) for k, v in final.items()}
    metrics["curve"] = {k: torch.stack([c[k] for c in curve]).cpu().numpy()
                        for k in ("loss", "train_acc")} if curve else {}
    metrics["seconds"] = seconds
    return model, metrics


def _synchronize(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
