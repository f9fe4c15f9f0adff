"""Citation-network models: the reference's canonical workload.

Counterpart of ``pytorch_geometric_tpu/models/citation.py`` and
``examples/gat.py``, trained full-batch for 200 epochs (Cora; the GAT on
PubMed too):

- a 2-layer GCN (hidden 16, dropout 0.5, Adam lr 0.01, weight decay 5e-4
  on the first layer only; reference examples/gcn.py:15-40), with the
  aggregation backends of ``bench_common.py:435-484``
  (:func:`gcn_backend`), over the self-looped ``gcn_norm`` edge set
  without its padding edges (:func:`gcn_edge_set`): ``"packed"``, the
  default, ``SpmmOperator.bind`` (the CSR SpMM kernel, 4 launches per
  epoch on a CUDA graph); ``"sorted"``, ``SortedSpmm`` (messages gathered
  in receiver order, the segment-sum kernel, 4 launches per epoch);
  ``"fused"``, ``FusedGcn2`` (both aggregations and the elementwise work
  between them, 2 forward and 2 backward launches per epoch, evaluation
  through ``SpmmOperator.bind_external``); ``"dense"``, the bf16 dense
  normalised adjacency, one matrix product per aggregation (N <= 8192);
  ``"hybrid"``, ``HybridSpmm`` (the JAX ``pallas=True`` path: the edges
  of dense (window, window) buckets from bf16 x, the rest in fp32, 8
  launches per epoch).
- a 2-layer GAT (8 heads x 8 channels, then 1 head x classes; dropout
  0.6 on the inputs and the attention; AdamW lr 5e-3, weight decay 5e-4;
  reference examples/gat.py). Every attention layer goes through one
  fused operator (:func:`gat_flash_op`): ``backend="packed"``, the
  default of the JAX example, is ``PackedFlashGat`` over the edge list;
  ``backend="dense"`` is ``FlashGatOperator`` over the (N, N) mask, for
  graphs of at most 8192 padded nodes; ``backend="bsr"`` is
  ``BsrFlashGat`` over the mask's active blocks, for any N. Whichever it
  is, on a CUDA graph, 1 forward launch and 2 backward launches per
  layer, so 2 + 4 per epoch.

``closure=True`` (the JAX ``create_gcn_train_step(closure=True)`` and the
closure GAT of ``bench_common.py:221-310``) trains on the two-layer
receptive field of the training nodes (``data/closure.py``): each layer
maps its input rows to its output rows through one operator built on the
host before any epoch (GCN: ``gcn_closure_operator``, one rectangular
``spmm_csr`` a direction; GAT: ``gat_closure_op``, a ``PackedFlashGat``),
so the launches per epoch are the full graph's; the loss reads the seeds'
rows; the evaluation runs on the full graph through ``backend``.

The JAX package runs the epochs as one ``lax.scan`` program; on a CUDA
device the port runs them as one captured CUDA graph, replayed once per
epoch after an eager first epoch (``models/capture.py``, the trainers'
``capture=`` argument; ``capture=False`` keeps the eager loop). Nothing
is copied to the host until the run ends. On a CPU graph the epochs run
eagerly, and each kernel's wrapper computes the same function in plain
PyTorch.
"""

import functools
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
from pytorch_geometric_tpu_torch.nn.conv.gat_conv import (
    GATConv, gat_closure_op, gat_dense_adj, gat_edge_set)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (
    GCNConv, gcn_closure_norm, gcn_closure_operator, gcn_edge_set, gcn_norm,
    gcn_norm_dense)
from pytorch_geometric_tpu_torch.nn.layers import dropout
from pytorch_geometric_tpu_torch.ops.bsr_gat import BsrFlashGat
from pytorch_geometric_tpu_torch.ops.flash_gat import (
    MAX_NODES, FlashGatOperator)
from pytorch_geometric_tpu_torch.ops.fused_gcn import FusedGcn2
from pytorch_geometric_tpu_torch.ops.hybrid_spmm import HybridSpmm
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSpmm
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

#: Largest padded node count of the GCN's dense backend (its (N, N) bf16
#: adjacency), where ``bench_common.py:436`` picks it.
GCN_DENSE_MAX_NODES = 8192


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
                norm_dense=None, aggregate_fn=None, closure=None,
                closure_norms=None,
                generator: Optional[torch.Generator] = None):
        """With ``closure`` (two ``ClosureLayer``s) and ``closure_norms``
        (their ``gcn_closure_norm``), ``x`` holds the first layer's input
        rows and ``aggregate_fn`` is None (plain sums, CPU only) or the
        pair of the layers' ``gcn_closure_operator``s; the rows returned
        are the last layer's output nodes, the seeds first."""
        if closure is not None:
            agg1, agg2 = aggregate_fn if aggregate_fn is not None \
                else (None, None)
            x = dropout(x, self.dropout_rate, train, generator)
            x = self.conv1(None, x, norm=closure_norms[0],
                           aggregate_fn=agg1, closure=closure[0])
            x = torch.relu(x)
            x = dropout(x, self.dropout_rate, train, generator)
            return self.conv2(None, x, norm=closure_norms[1],
                              aggregate_fn=agg2, closure=closure[1])
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
    """The ``SpmmOperator`` of :func:`gcn_edge_set` and its static
    weights."""
    senders, receivers, weights = gcn_edge_set(graph)
    return SpmmOperator(senders, receivers, graph.num_nodes,
                        device=graph.device), weights


def gcn_hybrid_operator(graph: Graph, window: int = 512, tile: int = 512):
    """The ``HybridSpmm`` of the JAX ``pallas=True`` trainer and its
    static weights: over ``gcn_norm``'s whole edge set, so that the
    window split (and ``dense_frac``) is the JAX one; the padding edges
    weigh 0 and are left out of its operators (``edge_mask``)."""
    norm = gcn_norm(graph)
    keep = torch.cat([graph.real_edge_mask(),
                      torch.ones(graph.num_nodes, dtype=torch.bool,
                                 device=graph.device)])
    return HybridSpmm(norm.senders, norm.receivers, graph.num_nodes,
                      window=window, tile=tile, device=graph.device,
                      edge_mask=keep), norm.weights


def gcn_backend(graph: Graph, backend: str = "packed", hidden: int = 16,
                classes: int = 7, dropout_rate: float = 0.5,
                window: int = 512, tile: int = 512):
    """The aggregation of ``backend`` on the graph's device:
    ``(forward_kwargs, fused)``. ``forward_kwargs`` go to ``GCN.forward``
    (``aggregate_fn=`` or ``norm_dense=``) for every layer of the packed,
    sorted and dense training and for every evaluation; ``fused`` is the
    ``FusedGcn2`` of ``"fused"`` (its training step), else None.

    - ``"packed"``: ``SpmmOperator.bind`` over :func:`gcn_edge_set`;
    - ``"sorted"``: ``SortedSpmm`` over the same edges, fp32 messages, so
      its logits equal the packed backend's;
    - ``"fused"``: ``FusedGcn2`` over the same edges (``hidden`` and
      ``classes`` at most 16); evaluation through its operator's
      ``bind_external``, dropout off, as ``bench_common.py:635-656``;
    - ``"dense"``: ``gcn_norm_dense`` in bf16, as the JAX
      ``create_gcn_train_step(dense=True)``; at most
      :data:`GCN_DENSE_MAX_NODES` padded nodes;
    - ``"hybrid"``: :func:`gcn_hybrid_operator` bound to its weights, as
      the JAX ``create_gcn_train_step(pallas=True)``; ``window`` and
      ``tile`` decide which edges are summed from bf16 x.
    """
    if backend == "dense":
        if graph.num_nodes > GCN_DENSE_MAX_NODES:
            raise ValueError(f"the dense GCN backend takes at most "
                             f"{GCN_DENSE_MAX_NODES} padded nodes, got "
                             f"{graph.num_nodes}")
        return {"norm_dense": gcn_norm_dense(graph, dtype=torch.bfloat16)}, \
            None
    if backend == "packed":
        op, weights = gcn_spmm_operator(graph)
        return {"aggregate_fn": op.bind(weights)}, None
    if backend == "hybrid":
        op, weights = gcn_hybrid_operator(graph, window, tile)
        return {"aggregate_fn": op.bind(weights)}, None
    if backend not in ("sorted", "fused"):
        raise ValueError(f"backend must be 'packed', 'sorted', 'fused', "
                         f"'dense' or 'hybrid', got {backend!r}")
    senders, receivers, weights = gcn_edge_set(graph)
    n = graph.num_nodes
    if backend == "sorted":
        sop = SortedSpmm(senders, receivers, n, device=graph.device)
        return {"aggregate_fn": functools.partial(sop, weights)}, None
    fused = FusedGcn2(senders, receivers, n, weights, hidden=hidden,
                      classes=classes, dropout_rate=dropout_rate,
                      device=graph.device)
    fn, consts = fused.op.bind_external(weights)
    return {"aggregate_fn": functools.partial(fn, consts)}, fused


def training_closure(graph: Graph, num_layers: int = 2):
    """The ``num_layers`` closure layers of the graph's training nodes
    over its real edges, on its device (``data/closure.py``)."""
    real = graph.real_edge_mask().cpu().numpy()
    ei = np.stack([graph.senders.cpu().numpy()[real],
                   graph.receivers.cpu().numpy()[real]])
    seeds = np.flatnonzero(graph.train_mask.cpu().numpy())
    return layered_training_closure(ei, seeds, num_layers,
                                    num_nodes=graph.num_nodes,
                                    device=graph.device), ei, seeds


def create_gcn_train_step(model: GCN, graph: Graph, weight_decay=5e-4,
                          lr=0.01, backend: str = "packed",
                          window: int = 512, tile: int = 512,
                          closure: bool = False):
    """Build ``(epoch_step, eval_fn)`` closures over a static graph, with
    every aggregation through :func:`gcn_backend` of ``backend``.

    ``epoch_step(generator)`` takes one Adam step and returns the epoch's
    ``{"loss", "train_acc"}`` as device scalars; ``generator`` draws the
    dropout masks (and, on ``"fused"``, the kernel's dropout seed after the
    input's mask). ``eval_fn()`` returns train/val/test accuracy. The step
    waits on nothing and copies nothing from the host, so a CUDA graph can
    hold it (``models/capture.py``); its Adam is ``epoch_step.optimizer``
    (to save and restore its state). On a CUDA graph Adam is built with
    ``capturable=True`` (its step count on the device) whether the run is
    captured or not, and the gradients are zeroed in place, never set to
    None, so they stay allocated across replays.

    On ``"fused"`` the logits are
    ``fused(dropout(x) @ conv1.weight, conv2.weight, conv1.bias, seed)
    + conv2.bias``, as ``bench_common.py:566-672``: the second dropout is
    the kernel's hash of (feature, node, seed).

    Weight decay is ``weight_decay * sum(p**2)`` over the first layer's
    weight and bias, added to the loss, as in the JAX package (the
    reference's per-group Adam, examples/gcn.py:31-34); it is not
    ``torch.optim.Adam(weight_decay=...)``, which adds ``wd * p`` to the
    gradient of every parameter. ``torch.optim.Adam`` and ``optax.adam``
    share b1, b2 and eps (added outside the square root).

    ``closure=True`` is the JAX ``_create_gcn_closure_train_step``: the
    epoch runs on the training nodes' closure (:func:`training_closure`,
    ``gcn_closure_norm`` from the full graph's degrees, one
    ``gcn_closure_operator`` a layer, all built here), x0 the first
    layer's input rows, the loss the mean over the seeds; the evaluation
    runs on the full graph through ``backend`` (``"fused"`` excluded: its
    operator trains, it does not evaluate alone).
    """
    if closure:
        if backend == "fused":
            raise ValueError("closure=True evaluates through backend; "
                             "'fused' has no evaluation of its own")
        return _create_gcn_closure_train_step(model, graph, weight_decay,
                                              lr, backend, window, tile)
    agg, fused = gcn_backend(graph, backend, model.conv1.out_channels,
                             model.conv2.out_channels, model.dropout_rate,
                             window, tile)
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           capturable=graph.device.type == "cuda")
    decayed = list(model.conv1.parameters())
    conv1, conv2 = model.conv1, model.conv2

    def logits_of(generator):
        if fused is None:
            return model(graph, graph.x, train=True, generator=generator,
                         **agg)
        z1 = dropout(graph.x, model.dropout_rate, True, generator) \
            @ conv1.weight
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=graph.device, dtype=torch.int32)
        return fused(z1, conv2.weight, conv1.bias, seed) + conv2.bias

    def epoch_step(generator: Optional[torch.Generator] = None):
        model.train()
        opt.zero_grad(set_to_none=False)
        logits = logits_of(generator)
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
        return _accuracies(model(graph, graph.x, **agg), graph)

    epoch_step.optimizer = opt
    return epoch_step, eval_fn


def _create_gcn_closure_train_step(model: GCN, graph: Graph,
                                   weight_decay=5e-4, lr=0.01,
                                   backend: str = "packed",
                                   window: int = 512, tile: int = 512):
    layers, ei, seeds = training_closure(graph)
    norms = gcn_closure_norm(ei, graph.num_nodes, layers)
    ops = tuple(gcn_closure_operator(cl, w_edge)
                for cl, (w_edge, _) in zip(layers, norms))
    x0 = graph.x[layers[0].in_global.long()]
    n_train = seeds.shape[0]
    labels = graph.y[torch.from_numpy(seeds).to(graph.device)].long()
    agg, _ = gcn_backend(graph, backend, model.conv1.out_channels,
                         model.conv2.out_channels, model.dropout_rate,
                         window, tile)
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           capturable=graph.device.type == "cuda")
    decayed = list(model.conv1.parameters())

    def epoch_step(generator: Optional[torch.Generator] = None):
        model.train()
        opt.zero_grad(set_to_none=False)
        logits = model(None, x0, train=True, closure=layers,
                       closure_norms=norms, aggregate_fn=ops,
                       generator=generator)[:n_train]
        loss = softmax_xent_int_labels(logits, labels).mean()
        loss = loss + weight_decay * sum((p ** 2).sum() for p in decayed)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(),
                "train_acc": (logits.detach().argmax(-1) == labels)
                .float().mean()}

    @torch.no_grad()
    def eval_fn():
        model.eval()
        return _accuracies(model(graph, graph.x, **agg), graph)

    epoch_step.optimizer = opt
    return epoch_step, eval_fn


def train_gcn(graph: Graph, num_classes: int, hidden: int = 16,
              epochs: int = 200, seed: int = 0, lr: float = 0.01,
              device="cuda", backend: str = "packed",
              capture: Optional[bool] = None, window: int = 512,
              tile: int = 512,
              closure: bool = False) -> Tuple[GCN, Dict[str, Any]]:
    """Full training run on ``device`` through the aggregation of
    ``backend`` (:func:`gcn_backend`): ``epochs`` Adam steps, then one
    evaluation, through ``models/capture.py:run_epochs`` (``capture``:
    None, the default, captures the epochs in a CUDA graph on a CUDA
    device and runs them eagerly on the CPU; False runs them eagerly on
    the card too; True on the CPU raises). Returns the model and its
    metrics: final ``train_acc`` / ``val_acc`` / ``test_acc``, the
    per-epoch ``curve`` (numpy arrays of ``loss`` and ``train_acc``), and
    ``seconds``, the wall time of the epochs and the evaluation (after the
    operator's host set-up, ending in a device synchronisation; a
    captured run keeps its warm-up epoch and capture apart, in
    ``capture_seconds``, and adds ``launches``). On a CUDA graph the
    packed backend launches ``spmm_csr`` 4 times per epoch and 2 for the
    evaluation, the sorted backend ``sorted_segment_sum`` likewise; the
    fused backend launches ``fused_gcn_fwd`` and ``fused_gcn_bwd`` twice
    per epoch each (two kernels a call) and ``spmm_csr`` 2 times for the
    evaluation; the dense
    backend launches no kernel of the port; the hybrid backend launches
    ``spmm_csr`` twice where the packed one launches it once (its dense
    and its sparse part; once where a part is empty), ``window`` and
    ``tile`` setting its split. ``closure=True`` trains on the closure
    (:func:`create_gcn_train_step`): ``spmm_csr`` 4 times per epoch over
    the closure's operators, 2 for the evaluation on the packed
    backend."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    graph = graph.to(dev)
    init_gen = torch.Generator().manual_seed(seed)
    model = GCN(graph.num_node_features, hidden, num_classes,
                generator=init_gen).to(dev)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    epoch_step, eval_fn = create_gcn_train_step(model, graph, lr=lr,
                                                backend=backend,
                                                window=window, tile=tile,
                                                closure=closure)
    return model, run_epochs(epoch_step, eval_fn, epochs, drop_gen, dev,
                             capture)


# ---------------------------------------------------------------------------
# GAT (examples/gat.py)
# ---------------------------------------------------------------------------

class GAT(nn.Module):
    """2-layer GAT: ``heads`` x ``hidden`` concatenated, ELU, then one
    head of ``num_classes`` channels; dropout on both layers' inputs and
    on the attention."""

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 8,
                 heads: int = 8, dropout_rate: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = GATConv(in_channels, hidden, heads=heads,
                             dropout=dropout_rate, generator=generator)
        self.conv2 = GATConv(hidden * heads, num_classes, heads=1,
                             concat=False, dropout=dropout_rate,
                             generator=generator)

    def forward(self, graph: Graph, x, *, train: bool = False, adj=None,
                flash_op=None, closure=None,
                generator: Optional[torch.Generator] = None):
        """With ``closure`` (two ``ClosureLayer``s), ``x`` holds the first
        layer's input rows and ``flash_op`` is the pair of the layers'
        ``gat_closure_op``s (None: built for the call, CPU only); the rows
        returned are the last layer's output nodes, the seeds first."""
        cl1, cl2 = closure if closure is not None else (None, None)
        op1, op2 = flash_op if closure is not None and flash_op is not None \
            else (flash_op, flash_op)
        x = dropout(x, self.dropout_rate, train, generator)
        x = self.conv1(graph, x, train=train, adj=adj, flash_op=op1,
                       closure=cl1, generator=generator)
        x = torch.nn.functional.elu(x)
        x = dropout(x, self.dropout_rate, train, generator)
        return self.conv2(graph, x, train=train, adj=adj, flash_op=op2,
                          closure=cl2, generator=generator)


def gat_flash_op(graph: Graph, backend: str = "packed"):
    """The fused attention operator of the graph (``make_flash_op`` in
    examples/gat.py), on the graph's device: one for both layers.
    ``"packed"`` builds ``PackedFlashGat`` over the edge list (any N,
    work that grows with the edges); ``"dense"`` builds
    ``FlashGatOperator`` over the (N, N) mask, small graphs only;
    ``"bsr"`` builds ``BsrFlashGat`` over the active blocks of the same
    mask, from the edge list (any N, no (N, N) matrix). Each launches its
    kernels on a CUDA graph. A node permutation changes no result; the
    block-sparse operator alone gains from one: reorder the host ``Data``
    first (``utils/reorder.py:reorder_graph``, RCM, as examples/gat.py
    does) and the same entries fall into fewer blocks. ``"auto"`` is
    ``"packed"``, as in ``make_flash_op``; its ``"none"`` (no fused
    operator: the plain segment-softmax path) is refused, because no
    trainer of the port sums feature rows with plain segment ops on a
    card."""
    if backend in ("auto", "packed"):
        senders, receivers = gat_edge_set(graph)
        return PackedFlashGat(senders=senders, receivers=receivers,
                              num_nodes=graph.num_nodes,
                              device=graph.device)
    if backend == "dense":
        if graph.num_nodes > MAX_NODES:
            raise ValueError(f"the dense operator takes at most {MAX_NODES} "
                             f"padded nodes, got {graph.num_nodes}")
        return FlashGatOperator(gat_dense_adj(graph), device=graph.device)
    if backend == "bsr":
        senders, receivers = gat_edge_set(graph)
        return BsrFlashGat.from_edges(senders, receivers, graph.num_nodes,
                                      device=graph.device)
    raise ValueError(f"backend must be 'auto', 'packed', 'dense' or 'bsr', "
                     f"got {backend!r}")


def create_gat_train_step(model: GAT, graph: Graph, lr: float = 5e-3,
                          weight_decay: float = 5e-4,
                          backend: str = "packed", closure: bool = False):
    """Build ``(epoch_step, eval_fn)`` closures over a static graph, as
    ``create_gcn_train_step``. Every attention layer runs through
    :func:`gat_flash_op` of ``backend`` (its kernels on a CUDA graph).
    The loss is the masked cross-entropy of the full logits, as in
    examples/gat.py.

    ``torch.optim.AdamW`` makes the same update as ``optax.adamw``:
    decoupled weight decay ``lr * wd * p`` on every parameter, and eps
    added outside the square root of the bias-corrected second moment.
    As in :func:`create_gcn_train_step`, on a CUDA graph it is built with
    ``capturable=True`` and the gradients are zeroed in place; the
    attention seeds are drawn on the device from ``generator``.

    ``closure=True`` is the closure GAT of ``bench_common.py:221-310``:
    the epoch runs on the training nodes' closure (:func:`training_closure`,
    one ``gat_closure_op`` a layer, built here), its input the first
    layer's input rows, the loss the mean over the seeds, attention
    dropout hashed from each closure edge's position (the JAX closure
    draws ``jax.random.bernoulli``: equal up to the dropout draws); the
    evaluation runs on the full graph through ``backend``.
    """
    flash_op = gat_flash_op(graph, backend)
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay,
                            capturable=graph.device.type == "cuda")
    if closure:
        layers, _, seeds = training_closure(graph)
        ops = tuple(gat_closure_op(cl) for cl in layers)
        x_in = graph.x[layers[0].in_global.long()]
        y_seed = graph.y[torch.from_numpy(seeds).to(graph.device)]
        seed_mask = torch.ones(seeds.shape[0], dtype=torch.bool,
                               device=graph.device)

        def train_logits(generator):
            return model(None, x_in, train=True, flash_op=ops,
                         closure=layers,
                         generator=generator)[:seeds.shape[0]], y_seed, \
                seed_mask
    else:
        def train_logits(generator):
            return model(graph, graph.x, train=True, flash_op=flash_op,
                         generator=generator), graph.y, graph.train_mask

    def epoch_step(generator: Optional[torch.Generator] = None):
        model.train()
        opt.zero_grad(set_to_none=False)
        logits, y, mask = train_logits(generator)
        loss = masked_softmax_xent(logits, y, mask)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(),
                "train_acc": masked_accuracy(logits.detach(), y, mask)}

    @torch.no_grad()
    def eval_fn():
        model.eval()
        return _accuracies(model(graph, graph.x, flash_op=flash_op), graph)

    return epoch_step, eval_fn


def train_gat(graph: Graph, num_classes: int, hidden: int = 8,
              heads: int = 8, epochs: int = 200, seed: int = 0,
              lr: float = 5e-3, weight_decay: float = 5e-4,
              device="cuda", backend: str = "packed",
              capture: Optional[bool] = None,
              closure: bool = False) -> Tuple[GAT, Dict[str, Any]]:
    """Full GAT training run on ``device`` through the fused operator of
    ``backend`` (:func:`gat_flash_op`), as examples/gat.py ``run``:
    ``epochs`` AdamW steps, then one evaluation, captured or not as
    ``capture`` says (:func:`train_gcn`). Returns the model and the
    metrics of :func:`train_gcn`. On a CUDA graph the operator's forward
    kernel launches 2 times per epoch and 2 for the evaluation, its
    backward kernels 4 times per epoch (``closure=True``: the same counts,
    the epochs over the closure's packed operators whatever
    ``backend`` evaluates)."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    graph = graph.to(dev)
    init_gen = torch.Generator().manual_seed(seed)
    model = GAT(graph.num_node_features, num_classes, hidden=hidden,
                heads=heads, generator=init_gen).to(dev)
    drop_gen = torch.Generator(device=dev).manual_seed(seed)
    epoch_step, eval_fn = create_gat_train_step(
        model, graph, lr=lr, weight_decay=weight_decay, backend=backend,
        closure=closure)
    return model, run_epochs(epoch_step, eval_fn, epochs, drop_gen, dev,
                             capture)


# ---------------------------------------------------------------------------

def _accuracies(logits, graph: Graph):
    return {f"{split}_acc": masked_accuracy(logits, graph.y,
                                            getattr(graph, f"{split}_mask"))
            for split in ("train", "val", "test")}
