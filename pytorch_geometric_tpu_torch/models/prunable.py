"""Configurable-width model zoo for the pruning pipeline.

Counterpart of ``pytorch_geometric_tpu/models/prunable.py`` (reference:
ConvexPruning.py:175-338, GCN3 / GAT3 / ChebNet / AGNN / SplineNet /
TopKNet, whose hidden widths come from a ``widths`` list so that the net
can be rebuilt smaller after SVD pruning, ConvexPruning.py:551-566).

The modules carry flax's names (``layers_{i}``, ``out``, ``prop_{i}``,
``pool_{i}``, ``proj_{i}``, ``lin1``), and a ``Dense`` keeps flax's
``kernel`` (in, out), so ``convert.params_from_jax`` carries a JAX
model's parameters across unchanged and ``research/pruning.py`` walks
them in the JAX order. Torch needs the input width, which flax reads off
the first call: every model takes ``in_channels``.

Each model aggregates through the graph's operators, built once per
graph on the host by ``model.operators(graph)`` and passed to the
forward as keywords:

- GCN: ``aggregate_fn``, ``models/citation.py:gcn_spmm_operator`` bound
  to its weights (``spmm_csr``, one launch a layer and one for its
  ``dh``);
- GAT: ``flash_op``, ``PackedFlashGat`` over ``gat_sparse_edge_set``
  (the JAX driver's remove-then-add edge set: real edges that are not
  self loops, repeats kept, one loop a node);
- Cheb: ``lap_fn`` (``cheb_operator``); AGNN: ``agnn_operators``;
- Spline: ``spline_op`` (one ``spline_operator`` serves every layer) and
  its ``pseudo``, 0.5 on every edge when the graph has no ``edge_attr``,
  as the JAX model;
- TopK: GraphConv's ``spmm_op`` over the batch's real edges and the
  readout's ``pool_op`` (``pool_operator``), as
  examples/enzymes_topk_pool.py (``examples/mutag_gin.py:
  mutag_operators``).

GCN and TopK, the models of research/driver.py's captured inductive
phases, also give their operators' static forms,
``model.static_operators(num_nodes, num_edges, num_graphs, device)``:
buffers of a loader's budget, into which each batch's operators load
(``models/capture.py:StaticBatch``). GCN's bound SpMM is
``ops/spmm.py:spmm_static`` over the operator's geometry, the call of
``SpmmOperator.bind``, in the form a ``StaticBiSpmm`` loads. The other
models have none, and their inductive phases run eagerly.

Without its operators a model sums with plain segment ops on a CPU
tensor only, and raises on any other (``require_cpu``). Dropout draws
its masks from the caller's ``generator``.
"""

import functools
from typing import Optional, Sequence

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn.conv import (
    AGNNConv, ChebConv, GATConv, GCNConv, GraphConv, SplineConv,
    agnn_operators, cheb_operator, gat_sparse_edge_set, gcn_norm)
from pytorch_geometric_tpu_torch.nn.conv.spline_conv import spline_operator
from pytorch_geometric_tpu_torch.nn.layers import Dense, dropout
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.nn.pool import (
    TopKPooling, global_max_pool, global_mean_pool, pool_operator)
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
from pytorch_geometric_tpu_torch.ops.sorted_spmm import StaticSegmentSum
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, StaticBiSpmm, StaticSpmmOperator)


def _layers(model: nn.Module, prefix: str, count: int):
    return [getattr(model, f"{prefix}_{i}") for i in range(count)]


def _bound(op: SpmmOperator, weights):
    """``op.bind(weights)``'s call as ``spmm_static`` over ``op``'s
    geometry and routed weights: a ``functools.partial`` that a
    ``StaticBiSpmm`` loads."""
    fn, consts = op.bind_external(weights)
    return functools.partial(fn, consts)


class PrunableGCN(nn.Module):
    """GCN stack with per-layer widths (reference GCN3,
    ConvexPruning.py:180-200): ``layers_{i}`` GCNConv, ReLU, dropout;
    ``out`` GCNConv to the classes."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 dropout: float = 0.5, *, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.dropout = dropout
        prev = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"layers_{i}", GCNConv(prev, w,
                                                 generator=generator))
            prev = w
        self.out = GCNConv(prev, num_classes, generator=generator)

    def operators(self, graph: Graph):
        """``aggregate_fn``: the GCN edge set's bound SpMM, its weights
        computed on a CPU copy of the graph (so that a batch collated on
        the card and the same batch collated on the host give the same
        operator), on the graph's device."""
        op, weights = gcn_spmm_operator(graph.to("cpu"))
        return {"aggregate_fn": _bound(op.to(graph.device), weights)}

    @staticmethod
    def static_operators(num_nodes: int, num_edges: int, num_graphs: int,
                         device):
        """The static form of :meth:`operators`: the GCN edge set's real
        edges and a self loop a node."""
        return {"aggregate_fn": StaticBiSpmm(num_nodes, num_nodes,
                                             num_edges + num_nodes,
                                             device=device)}

    def forward(self, graph: Graph, x, *, train: bool = False,
                aggregate_fn=None,
                generator: Optional[torch.Generator] = None):
        norm = None
        if aggregate_fn is None:
            require_cpu(x, "PrunableGCN", "aggregate_fn (operators)")
            norm = gcn_norm(graph)
        for conv in _layers(self, "layers", len(self.widths)):
            x = torch.relu(conv(graph, x, norm=norm,
                                aggregate_fn=aggregate_fn))
            x = dropout(x, self.dropout, train, generator)
        return self.out(graph, x, norm=norm, aggregate_fn=aggregate_fn)


class PrunableGAT(nn.Module):
    """``layers_{i}``: GATConv of ``heads`` x max(w // heads, 1)
    channels, ELU, dropout; ``out``: one head of the classes,
    averaged."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 heads: int = 8, dropout: float = 0.6, *, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.heads = heads
        self.dropout = dropout
        prev = in_channels
        for i, w in enumerate(self.widths):
            c = max(w // heads, 1)
            setattr(self, f"layers_{i}", GATConv(
                prev, c, heads=heads, dropout=dropout, generator=generator))
            prev = heads * c
        self.out = GATConv(prev, num_classes, heads=1, concat=False,
                           generator=generator)

    def operators(self, graph: Graph):
        senders, receivers = gat_sparse_edge_set(graph)
        return {"flash_op": PackedFlashGat(
            senders=senders, receivers=receivers,
            num_nodes=graph.num_nodes, device=graph.device)}

    def forward(self, graph: Graph, x, *, train: bool = False,
                flash_op=None, generator: Optional[torch.Generator] = None):
        if flash_op is None:
            require_cpu(x, "PrunableGAT", "flash_op (operators)")
        for conv in _layers(self, "layers", len(self.widths)):
            x = torch.nn.functional.elu(conv(
                graph, x, train=train, flash_op=flash_op,
                generator=generator))
            x = dropout(x, self.dropout, train, generator)
        return self.out(graph, x, train=train, flash_op=flash_op,
                        generator=generator)


class PrunableCheb(nn.Module):
    """``layers_{i}``: ChebConv (K), ReLU, dropout; ``out`` ChebConv."""

    def __init__(self, widths: Sequence[int], num_classes: int, K: int = 2,
                 dropout: float = 0.5, *, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.K = K
        self.dropout = dropout
        prev = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"layers_{i}", ChebConv(prev, w, K,
                                                  generator=generator))
            prev = w
        self.out = ChebConv(prev, num_classes, K, generator=generator)

    def operators(self, graph: Graph):
        return {"lap_fn": cheb_operator(graph)}

    def forward(self, graph: Graph, x, *, train: bool = False, lap_fn=None,
                generator: Optional[torch.Generator] = None):
        if lap_fn is None:
            require_cpu(x, "PrunableCheb", "lap_fn (operators)")
        for conv in _layers(self, "layers", len(self.widths)):
            x = torch.relu(conv(graph, x, lap_fn=lap_fn))
            x = dropout(x, self.dropout, train, generator)
        return self.out(graph, x, lap_fn=lap_fn)


class PrunableAGNN(nn.Module):
    """Dense-in -> AGNN propagation x (len(widths) - 1) -> dense-out
    (reference ConvexPruning.py:236-258): ``layers_0`` Dense to
    ``widths[0]``, ``prop_{i}`` AGNNConv with a trained beta, ``out``
    Dense to the classes."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 dropout: float = 0.5, *, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.dropout = dropout
        self.layers_0 = Dense(in_channels, self.widths[0],
                              generator=generator)
        for i in range(1, len(self.widths)):
            setattr(self, f"prop_{i}", AGNNConv(requires_grad=True))
        self.out = Dense(self.widths[0], num_classes, generator=generator)

    def operators(self, graph: Graph):
        return agnn_operators(graph)

    def forward(self, graph: Graph, x, *, train: bool = False, spmm_op=None,
                recv_op=None, send_op=None,
                generator: Optional[torch.Generator] = None):
        if spmm_op is None:
            require_cpu(x, "PrunableAGNN", "spmm_op, recv_op and send_op "
                        "(operators)")
        x = dropout(x, self.dropout, train, generator)
        x = torch.relu(self.layers_0(x))
        for i in range(1, len(self.widths)):
            x = getattr(self, f"prop_{i}")(graph, x, spmm_op=spmm_op,
                                           recv_op=recv_op, send_op=send_op)
        x = dropout(x, self.dropout, train, generator)
        return self.out(x)


def _pseudo(graph: Graph):
    """The pseudo-coordinates of the graph's edges, (E, dim): its
    ``edge_attr``, or 0.5 everywhere (the centre of the open-spline
    domain) when it has none."""
    pseudo = graph.edge_attr
    if pseudo is None:
        return torch.full((graph.num_edges, 1), 0.5, dtype=torch.float32,
                          device=graph.device)
    return pseudo[:, None] if pseudo.ndim == 1 else pseudo


class PrunableSpline(nn.Module):
    """SplineConv stack with per-layer widths (reference SplineNet,
    ConvexPruning.py:278-299: kernel_size 2, swish ``x * sigmoid(x)``
    between layers). ``dim`` is the pseudo-coordinates' width, which flax
    reads off the graph: 1 for a graph without ``edge_attr``."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 dropout: float = 0.0, *, in_channels: int, dim: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.dropout = dropout
        self.dim = dim
        prev = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"layers_{i}", SplineConv(
                prev, w, dim=dim, kernel_size=2, generator=generator))
            prev = w
        self.out = SplineConv(prev, num_classes, dim=dim, kernel_size=2,
                              generator=generator)

    def operators(self, graph: Graph):
        pseudo = _pseudo(graph)
        return {"spline_op": spline_operator(graph, self.dim, 2,
                                             pseudo=pseudo),
                "pseudo": pseudo}

    def forward(self, graph: Graph, x, *, train: bool = False,
                spline_op=None, pseudo=None,
                generator: Optional[torch.Generator] = None):
        if spline_op is None:
            require_cpu(x, "PrunableSpline", "spline_op (operators)")
        if pseudo is None:
            pseudo = _pseudo(graph)
        for conv in _layers(self, "layers", len(self.widths)):
            x = conv(graph, x, pseudo=pseudo, spline_op=spline_op)
            x = x * torch.sigmoid(x)
        return self.out(graph, x, pseudo=pseudo, spline_op=spline_op)


class PrunableTopK(nn.Module):
    """GraphConv + TopKPooling graph classifier (reference TopKNet,
    ConvexPruning.py:306-338): per level ``layers_{i}`` GraphConv (ReLU)
    and ``pool_{i}`` TopKPooling, its max ‖ mean readout projected by
    ``proj_{i}`` to ``2 * widths[-1]``; the projections summed, ``lin1``
    (ReLU, dropout 0.5) and ``out``."""

    def __init__(self, widths: Sequence[int], num_classes: int,
                 ratio: float = 0.8, *, in_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.num_classes = num_classes
        self.ratio = ratio
        common = 2 * self.widths[-1]
        prev = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"layers_{i}", GraphConv(prev, w,
                                                   generator=generator))
            setattr(self, f"pool_{i}", TopKPooling(w, ratio=ratio,
                                                   generator=generator))
            setattr(self, f"proj_{i}", Dense(2 * w, common,
                                             generator=generator))
            prev = w
        self.lin1 = Dense(common, self.widths[-1], generator=generator)
        self.out = Dense(self.widths[-1], num_classes, generator=generator)

    def operators(self, graph: Graph):
        """The ``SpmmOperator`` of the batch's real edges (a padding edge
        weighs 0 at every level, so each real row's sum is the padded
        operator's) and the readout's ``pool_operator``."""
        return {"spmm_op": SpmmOperator(graph.senders, graph.receivers,
                                        graph.num_nodes,
                                        edge_mask=graph.real_edge_mask(),
                                        device=graph.device),
                "pool_op": pool_operator(graph)}

    @staticmethod
    def static_operators(num_nodes: int, num_edges: int, num_graphs: int,
                         device):
        """The static form of :meth:`operators`."""
        return {"spmm_op": StaticSpmmOperator(num_nodes, num_edges,
                                              device=device),
                "pool_op": StaticSegmentSum(num_graphs, num_nodes,
                                            device=device)}

    def forward(self, graph: Graph, *, train: bool = False, spmm_op=None,
                pool_op=None, generator: Optional[torch.Generator] = None):
        x = graph.x
        if spmm_op is None:
            require_cpu(x, "PrunableTopK", "spmm_op and pool_op "
                        "(operators)")
        g = graph
        summaries = []
        for i in range(len(self.widths)):
            x = torch.relu(getattr(self, f"layers_{i}")(g, x,
                                                         spmm_op=spmm_op))
            g = g.replace(x=x)
            g, x, _ = getattr(self, f"pool_{i}")(g, x)
            s = torch.cat([global_max_pool(x, g),
                           global_mean_pool(x, g, segment_op=pool_op)], 1)
            summaries.append(getattr(self, f"proj_{i}")(s))
        h = sum(summaries)
        h = torch.relu(self.lin1(h))
        h = dropout(h, 0.5, train, generator)
        return self.out(h)


MODEL_ZOO = {
    "GCN": PrunableGCN,
    "GAT": PrunableGAT,
    "Cheb": PrunableCheb,
    "AGNN": PrunableAGNN,
    "Spline": PrunableSpline,
    "TopK": PrunableTopK,
}


def choose_model(name: str, widths: Sequence[int], num_classes: int,
                 **kwargs):
    """Reference ChooseModel (ConvexPruning.py:31-44). ``kwargs`` go to
    the model: ``in_channels`` is required, ``generator`` draws the
    initial weights."""
    try:
        cls = MODEL_ZOO[name]
    except KeyError:
        raise ValueError(
            f"model {name!r} not in zoo {sorted(MODEL_ZOO)}") from None
    return cls(widths=tuple(int(w) for w in widths),
               num_classes=num_classes, **kwargs)
