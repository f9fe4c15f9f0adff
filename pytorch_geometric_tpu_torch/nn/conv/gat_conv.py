"""GAT convolution (Veličković et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/gat_conv.py`` (reference:
``torch_geometric.nn.GATConv`` of PyG 1.4.x). Semantics: h = x W per
head; per-edge logits e_ij = LeakyReLU(a_src . h_j + a_dst . h_i); alpha
= softmax over each receiver's incoming edges; out_i = sum_j alpha_ij
h_j; heads concatenated or averaged; bias added after.

Aggregation paths, as in the JAX module (``flash_op`` is taken before
``adj``, as there):

- the sparse segment-softmax path (no ``adj``, no ``flash_op``), with PyG's
  remove-then-add self loops: a pre-existing self edge is masked out
  and each node gets one appended loop. It is the fp32 reference.
- the dense path (``adj=gat_dense_adj(graph)``): masked (H, N, N)
  logits, a row softmax and one batched product, in plain PyTorch and
  fp32. It is the reference of the dense-mask fused operator, not a path
  a trainer uses; duplicate edges collapse to one softmax slot.
- the fused path (``flash_op=``): ``PackedFlashGat`` (``ops/packed_gat.py``,
  over the edge list), ``FlashGatOperator`` (``ops/flash_gat.py``, over
  the dense mask) or ``BsrFlashGat`` (``ops/bsr_gat.py``, over the mask's
  active blocks), one kernel forward, two backward; the
  attention-dropout seed is drawn on the device from the caller's
  generator. ``raw_out=True`` returns the packed operator's undivided
  num‖den (the bias is still created, not added).

- the closure path (``closure=``, a ``data/closure.py:ClosureLayer``):
  attention over the seeds' receptive field only, as the JAX
  ``_closure_call``. The layer's output nodes are a prefix of its
  ``n_in`` input nodes, so it runs as the fused path over a square graph
  of ``n_in`` rows whose first ``n_out`` hold every edge
  (:func:`gat_closure_op`), and returns those rows. Without ``flash_op``
  the operator is built for the call, on a CPU tensor only.

- the shard path (``shard_ctx=``, parallel/api.py): x is this rank's
  (S, F) shard, and the softmax crosses the partition through
  ``parallel/partition.py:halo_gat`` (one halo exchange, the packed GAT
  over the rank's edges and the received rows). The partition appends
  the self loops. No attention dropout on this path, as in the JAX
  module.

``weight`` is (in, H*C) and ``att_src`` / ``att_dst`` are (1, H, C), as
in the JAX module.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.closure import real_edges
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
from pytorch_geometric_tpu_torch.ops.segment import (
    segment_max, segment_softmax, segment_sum)


def gat_edge_set(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """``(senders, receivers)`` of the fused path, on the host: the
    unique real (receiver, sender) pairs plus one self loop for every
    node, padding nodes included, in row-major (receiver, sender) order.

    Counterpart of ``np.nonzero(gat_dense_adj(graph))`` without the
    (N, N) matrix. Padding edges are left out and duplicate edges
    collapse to one, as in the JAX fused path (the sparse path sums
    them). The position of an edge in this order is its edge id, from
    which the fused kernels hash attention dropout."""
    n = graph.num_nodes
    mask = graph.real_edge_mask().cpu().numpy()
    loop = np.arange(n, dtype=np.int64)
    s = np.concatenate([graph.senders.cpu().numpy()[mask], loop])
    r = np.concatenate([graph.receivers.cpu().numpy()[mask], loop])
    key = np.unique(r * n + s)
    return key % n, key // n


def gat_sparse_edge_set(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """``(senders, receivers)`` on the host of the sparse path's softmax
    slots, for a fused operator (``PackedFlashGat``) that computes what
    the sparse path computes: the real edges that are not self loops,
    duplicates kept, and one self loop for every node, padding nodes
    included, with receivers in the collated (receiver-sorted) order and
    each node's loop after its real edges.

    It differs from :func:`gat_edge_set` on a multigraph. The sparse path
    (``GATConv`` without ``adj`` or ``flash_op``, as examples/ppi.py runs
    it) gives each copy of a repeated edge a softmax slot of its own, and
    masks out pre-existing self loops and the padding edges (self loops
    of the padding node); ``gat_edge_set`` is the dense mask's entry list,
    where a repeated edge is one entry. The position of an edge in this
    list is its edge id for attention dropout."""
    n = graph.num_nodes
    s = graph.senders.cpu().numpy().astype(np.int64)
    r = graph.receivers.cpu().numpy().astype(np.int64)
    keep = graph.real_edge_mask().cpu().numpy() & (s != r)
    loop = np.arange(n, dtype=np.int64)
    s = np.concatenate([s[keep], loop])
    r = np.concatenate([r[keep], loop])
    order = np.argsort(r, kind="stable")
    return s[order], r[order]


def gat_closure_op(closure, device=None) -> PackedFlashGat:
    """The fused attention operator of one closure layer, on ``device``
    (the layer's by default): ``PackedFlashGat`` over a square graph of
    the layer's ``n_in`` input nodes. Its edges are the layer's real
    edges without the receivers' existing self edges (the JAX path masks
    them to -1e9, which exp makes an exact 0), duplicates kept, and one
    self loop ``(i, i)`` for every output row ``i < n_out`` (an output
    node is input node ``i``), sorted stably by receiver. Rows ``n_out``
    to ``n_in - 1`` hold no edge: their output is 0, and nothing reads
    them. The position of an edge in this list is its dropout id."""
    s, _, r, _ = real_edges(closure)
    keep = s != r
    loop = np.arange(closure.n_out, dtype=np.int64)
    s = np.concatenate([s[keep], loop])
    r = np.concatenate([r[keep], loop])
    order = np.argsort(r, kind="stable")
    return PackedFlashGat(senders=s[order], receivers=r[order],
                          num_nodes=closure.n_in,
                          device=device or closure.senders.device)


def gat_dense_adj(graph: Graph, add_self_loops: bool = True) -> torch.Tensor:
    """Boolean (N, N) mask on the graph's device with ``adj[i, j]`` true
    iff there is an edge j -> i. Padding edges are left out; the self
    loops (padding nodes' included) give every row a valid entry, so a
    masked row softmax never sees an empty row. With self loops it is the
    scatter of :func:`gat_edge_set`."""
    n = graph.num_nodes
    mask = graph.real_edge_mask()
    adj = torch.zeros((n, n), dtype=torch.bool, device=graph.device)
    adj[graph.receivers[mask].long(), graph.senders[mask].long()] = True
    if add_self_loops:
        adj.fill_diagonal_(True)
    return adj


class GATConv(nn.Module):
    """``heads`` attention heads of ``out_channels`` each, concatenated
    (``concat``) or averaged; see the module docstring for the paths."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 dropout: float = 0.0, use_bias: bool = True,
                 add_self_loops: bool = True, raw_out: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, C = heads, out_channels
        self.in_channels, self.out_channels, self.heads = in_channels, C, H
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.add_self_loops = add_self_loops
        self.raw_out = raw_out
        self.weight = nn.Parameter(glorot((in_channels, H * C), generator))
        self.att_src = nn.Parameter(glorot((1, H, C), generator))
        self.att_dst = nn.Parameter(glorot((1, H, C), generator))
        self.bias = nn.Parameter(zeros((H * C,) if concat else (C,))) \
            if use_bias else None

    def forward(self, graph: Graph, x, *, train: bool = False, adj=None,
                flash_op=None, closure=None,
                generator: Optional[torch.Generator] = None,
                shard_ctx=None):
        H, C = self.heads, self.out_channels
        if shard_ctx is not None:
            return self._shard_call(shard_ctx, x)
        if self.raw_out and (adj is not None or flash_op is None
                             or closure is not None):
            # the raw num‖den only exists on the fused path; the others
            # return finalized output, which the caller would divide again
            raise ValueError("GATConv(raw_out=True) requires the fused "
                             "flash_op path (no adj, no closure)")
        if closure is not None:
            if adj is not None:
                raise ValueError("GATConv takes closure= or adj=, not both")
            if flash_op is None:
                require_cpu(x, "GATConv(closure=)",
                            "flash_op=gat_closure_op(closure)")
                flash_op = gat_closure_op(closure, x.device)
        N = x.shape[0] if closure is not None else graph.num_nodes
        h2 = x @ self.weight                                     # (N, HC)
        h = h2.reshape(N, H, C)
        alpha_src = (h * self.att_src).sum(-1)                   # (N, H)
        alpha_dst = (h * self.att_dst).sum(-1)
        if closure is not None:
            return self._flash_call(flash_op, h2, alpha_src, alpha_dst,
                                    train, generator)[:closure.n_out]
        if flash_op is not None:
            return self._flash_call(flash_op, h2, alpha_src, alpha_dst,
                                    train, generator)
        if adj is not None:
            return self._finalize(self._dense_attention(
                h, alpha_src, alpha_dst, adj, train, generator))

        senders, receivers = graph.senders.long(), graph.receivers.long()
        if self.add_self_loops:
            loop = torch.arange(N, device=senders.device)
            senders = torch.cat([senders, loop])
            receivers = torch.cat([receivers, loop])
        logits = alpha_src[senders] + alpha_dst[receivers]   # (E', H)
        logits = torch.nn.functional.leaky_relu(logits, self.negative_slope)
        if self.add_self_loops:
            # PyG removes self loops, then adds one per node: pre-existing
            # self edges get no softmax slot of their own
            dup = senders == receivers
            dup[graph.num_edges:] = False
            logits = torch.where(dup[:, None], -1e9, logits)
        E2 = senders.shape[0]
        if self.dropout > 0 and train:
            # dropout acts on the normalised alpha (PyG semantics)
            alpha = segment_softmax(logits, receivers, N)
            keep = torch.rand(alpha.shape, generator=generator,
                              device=alpha.device) < 1.0 - self.dropout
            alpha = torch.where(keep, alpha / (1.0 - self.dropout), 0.0)
            out = segment_sum(h[senders] * alpha[..., None], receivers,
                              N).reshape(N, H * C)
        else:
            # one segment sum carries the weighted messages and the
            # softmax denominator
            seg_max = segment_max(logits.detach(), receivers, N)
            expv = torch.exp(logits - seg_max[receivers])        # (E', H)
            weighted = h[senders] * expv[..., None]
            fused = torch.cat([weighted.reshape(E2, H * C), expv], dim=1)
            summed = segment_sum(fused, receivers, N)            # (N, HC+H)
            denom = summed[:, H * C:].clamp_min(1e-16)
            out = (summed[:, :H * C].reshape(N, H, C)
                   / denom[..., None]).reshape(N, H * C)
        return self._finalize(out)

    def _shard_call(self, ctx, x):
        from pytorch_geometric_tpu_torch.parallel.partition import halo_gat

        H, C = self.heads, self.out_channels
        h2 = x @ self.weight
        h = h2.reshape(-1, H, C)
        alpha_src = (h * self.att_src).sum(-1)                   # (S, H)
        alpha_dst = (h * self.att_dst).sum(-1)
        out = halo_gat(h2, alpha_src, alpha_dst, ctx.consts["tables"],
                       ctx.group, ctx.halo_size, ctx.num_peers, H,
                       self.negative_slope, op=ctx.consts.get("gat_op"))
        return self._finalize(out)

    def _flash_call(self, flash_op, h2, alpha_src, alpha_dst, train,
                    generator):
        if self.dropout > 0 and train:
            # drawn on the device: nothing waits on the card for it
            seed = torch.randint(0, 1 << 20, (1,), generator=generator,
                                 device=h2.device, dtype=torch.int32)
            rate = self.dropout
        else:
            seed, rate = 0, 0.0
        out = flash_op(alpha_dst, alpha_src, h2, seed, rate=rate,
                       raw_out=self.raw_out)
        return out if self.raw_out else self._finalize(out)

    def _dense_attention(self, h, alpha_src, alpha_dst, adj, train,
                         generator):
        """Masked (H, N, N) logits, row softmax, dropout of the
        normalised alpha from ``generator``, one batched product; fp32
        (the JAX module runs this chain in bf16)."""
        N, H, C = h.shape
        logits = alpha_dst.t()[:, :, None] + alpha_src.t()[:, None, :]
        logits = torch.nn.functional.leaky_relu(logits, self.negative_slope)
        # -1e9 underflows exp() to an exact 0 beside any valid entry
        logits = torch.where(adj[None], logits, -1e9)
        alpha = torch.softmax(logits, dim=-1)
        if self.dropout > 0 and train:
            keep = torch.rand(alpha.shape, generator=generator,
                              device=alpha.device) < 1.0 - self.dropout
            alpha = torch.where(keep, alpha / (1.0 - self.dropout), 0.0)
        out = torch.bmm(alpha, h.transpose(0, 1))            # (H, N, C)
        return out.transpose(0, 1).reshape(N, H * C)

    def _finalize(self, out):
        """Head concat or mean, then bias, on the flat (N, H*C) block
        (``_finalize`` and ``_finalize2d`` of the JAX module)."""
        if not self.concat:
            out = out.reshape(out.shape[0], self.heads, -1).mean(dim=1)
        if self.bias is not None:
            out = out + self.bias
        return out
