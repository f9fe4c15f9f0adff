"""Relational GCN (Schlichtkrull et al.).

Counterpart of ``pytorch_geometric_tpu/nn/conv/rgcn_conv.py`` (reference:
``torch_geometric.nn.RGCNConv`` of PyG 1.4.x, mean aggregation per
relation): x'_i = W_root x_i + sum_r mean_{j in N_r(i)} W_r x_j, with the
basis decomposition W_r = sum_b a_rb B_b.

Full-graph aggregation paths, as in the JAX module:

- ``fused_op`` (with ``num_bases > 0``): the basis-contraction operator
  of :func:`rgcn_fused_op`, ``fused_op(xB2d, att)`` with ``xB2d`` the
  basis table itself (``x=None``, node-id embeddings) or ``x @ basis``.
  The operator is ``ops/packed_rgcn.py:PackedRgcnSpmm``: the hand-written
  kernels on a CUDA graph, their plain versions on a CPU graph;
- embedding mode (``x=None``): one row of the (R * F_in, C) weight table
  per edge by the fused id ``relation * F_in + sender``;
- transform-first (``C < F_in``): project every node per relation, then
  gather per edge;
- aggregate-first otherwise: a relation-bucketed segment sum, then one
  contraction with W.

The closure path (``closure=``, a ``data/closure.py:ClosureLayer``, with
``norm`` its :func:`rgcn_closure_norm`) is the same function on the
seeds' receptive field: the edges are the layer's, into its ``n_out``
rows; in embedding mode the senders are the global ids
``sender_global`` (the table is indexed by node id) and the root term
gathers the rows of ``out_global``; with ``x`` (``n_in`` rows) the
senders are local and the root term reads ``x[self_idx]``. Its fused
operator is :func:`rgcn_closure_op`, a rectangular ``PackedRgcnSpmm``
over the layer's real edges (``num_nodes = n_out``), where the JAX
closure gathers rows of ``W = att @ basis``: the same sums, associated
otherwise.

On an edge partition (``shard_ctx``, parallel/api.py, built with
``edge_type=`` / ``num_relations=``; dense ``x`` only) the layer is
``parallel/partition.py:halo_rgcn``: one halo exchange of x, every
relation's mean in one ``spmm_csr`` over the rank's relation-major CSR,
the basis combine after. Parameters: ``basis`` (B, F_in, C) (B = R when ``num_bases=0``),
``att`` (R, B) (only with bases), ``root`` (F_in, C), ``bias`` (C,).
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.closure import real_edges
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import glorot, zeros
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.packed_rgcn import PackedRgcnSpmm
from pytorch_geometric_tpu_torch.ops.segment import segment_sum


def rgcn_norm(graph: Graph, edge_type, num_relations: int):
    """Static per-edge mean-normalisation weights 1/|N_r(i)|, 0 on padding
    edges. They depend only on the graph: compute once and reuse across
    layers and epochs."""
    R = num_relations
    emask = graph.real_edge_mask().to(torch.float32)
    fused_rr = graph.receivers.long() * R + edge_type.long()
    cnt = segment_sum(emask, fused_rr, graph.num_nodes * R)
    inv = torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0), 0.0)
    return inv[fused_rr] * emask


class RGCNConv(nn.Module):
    """``in_channels`` is the embedding table's row count when ``x`` is
    None (embedding mode); ``num_bases=0`` keeps one full weight per
    relation."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_relations: int, num_bases: int = 0,
                 root_weight: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_relations, self.num_bases = num_relations, num_bases
        R, F_in, C = num_relations, in_channels, out_channels
        B = num_bases if num_bases > 0 else R
        self.basis = nn.Parameter(glorot((B, F_in, C), generator))
        self.att = nn.Parameter(glorot((R, B), generator)) \
            if num_bases > 0 else None
        self.root = nn.Parameter(glorot((F_in, C), generator)) \
            if root_weight else None
        self.bias = nn.Parameter(zeros((C,))) if use_bias else None

    def _shard_call(self, ctx, x):
        """The edge-partition path (``parallel/partition.py:halo_rgcn``);
        dense ``x`` only."""
        if x is None:
            raise ValueError("RGCNConv(shard_ctx=) takes dense x; the "
                             "embedding mode stays single-device")
        from pytorch_geometric_tpu_torch.parallel.partition import halo_rgcn

        R = self.num_relations
        att = self.att if self.att is not None else torch.eye(
            R, dtype=x.dtype, device=x.device)
        wl, wr = ctx.consts["rgcn_wl"], ctx.consts["rgcn_wr"]   # (R, E_*)
        out = halo_rgcn(x, self.basis, att,
                        [(wl[r], wr[r]) for r in range(R)],
                        ctx.consts["tables"], ctx.group, ctx.halo_size,
                        ctx.num_peers, root=self.root,
                        op=ctx.consts.get("rgcn_op"))
        return out + self.bias if self.bias is not None else out

    def forward(self, graph: Graph, x=None, edge_type=None, norm=None,
                fused_op=None, closure=None, shard_ctx=None):
        if shard_ctx is not None:
            return self._shard_call(shard_ctx, x)
        C, R = self.out_channels, self.num_relations
        basis, att = self.basis, self.att
        B, F_in = basis.shape[0], basis.shape[1]
        if x is not None and x.shape[-1] != F_in:
            raise ValueError(f"x has {x.shape[-1]} features, the layer "
                             f"{F_in}")
        if closure is not None:
            # bipartite: the layer's n_in input rows -> n_out output rows;
            # embedding rows are the global sender ids
            N = closure.n_out
            senders = (closure.sender_global if x is None
                       else closure.senders).long()
            receivers = closure.receivers.long()
            et = closure.edge_type.long()
            if fused_op is None or att is None:
                require_cpu(basis, "RGCNConv(closure=)",
                            "fused_op=rgcn_closure_op(...)")
                if norm is None:
                    norm = rgcn_closure_norm(closure, R)
        else:
            N = graph.num_nodes
            senders = graph.senders.long()
            receivers = graph.receivers.long()
            et = (edge_type if edge_type is not None
                  else graph.edge_type).long()

        if fused_op is not None and att is not None:
            if x is None:
                xB2d = basis.transpose(0, 1).reshape(F_in, B * C)
            else:
                xB2d = torch.einsum("nf,bfc->nbc", x, basis).reshape(
                    x.shape[0], B * C)
            out = fused_op(xB2d, att)
        else:
            # static per-(receiver, relation) mean normalisation; pass a
            # precomputed rgcn_norm to hoist it out of the epoch loop
            w_edge = norm if norm is not None else rgcn_norm(graph, et, R)
            W = torch.einsum("rb,bfc->rfc", att, basis) \
                if att is not None else basis               # (R, F_in, C)
            if x is None:
                table = W.reshape(R * F_in, C)
                rows = senders.clamp(0, F_in - 1)
                msgs = table[et * F_in + rows]
                out = segment_sum(msgs * w_edge[:, None], receivers, N)
            elif C < F_in:
                H = torch.einsum("nf,rfc->nrc", x, W)
                msgs = H.reshape(-1, C)[senders * R + et]
                out = segment_sum(msgs * w_edge[:, None], receivers, N)
            else:
                x_j = x[senders] * w_edge[:, None]
                agg = segment_sum(x_j, receivers * R + et, N * R)
                out = torch.einsum("nrf,rfc->nc", agg.reshape(N, R, F_in),
                                   W)

        if self.root is not None:
            if x is None:
                idx = (closure.out_global.long() if closure is not None
                       else torch.arange(N, device=out.device))
                out = out + self.root[idx.clamp(0, F_in - 1)]
            elif closure is not None:
                out = out + x[closure.self_idx.long()] @ self.root
            else:
                out = out + x @ self.root
        if self.bias is not None:
            out = out + self.bias
        return out


def rgcn_fused_op(graph: Graph, edge_type, num_relations: int, mode: str,
                  in_channels: Optional[int] = None, norm=None):
    """Build the fused aggregation operator of one ``RGCNConv`` layer, a
    ``PackedRgcnSpmm`` on the graph's device.

    ``mode="embed"``: the ``x=None`` layer, whose source rows are the
    ``in_channels`` rows of the basis table; ``mode="transform"``: a
    dense-``x`` layer, whose source rows are the graph's nodes.

    Mean normalisation is baked into the operator's static weights (pass
    a precomputed ``rgcn_norm`` to avoid recomputing it), and the
    collation's padding edges are dropped: their weight is 0, and kept
    they would all land in the padding node's row.
    """
    if mode not in ("embed", "transform"):
        raise ValueError(f"mode must be 'embed' or 'transform', not {mode!r}")
    R = num_relations
    et_t = edge_type if edge_type is not None else graph.edge_type
    w_t = norm if norm is not None else rgcn_norm(
        graph, torch.as_tensor(et_t, device=graph.device), R)
    et = host_array(et_t).astype(np.int64)
    w = host_array(w_t).astype(np.float32)
    s = host_array(graph.senders).astype(np.int64)
    r = host_array(graph.receivers).astype(np.int64)
    real = host_array(graph.real_edge_mask())
    if not real.all():
        s, r, et, w = s[real], r[real], et[real], w[real]
    N = graph.num_nodes
    if mode == "embed" and in_channels is None:
        raise ValueError("mode='embed' needs in_channels, the basis "
                         "table's row count")
    src_rows = int(in_channels) if mode == "embed" else N
    return PackedRgcnSpmm(s, r, et, R, N, weights=w, num_src_rows=src_rows,
                          device=graph.device)


def rgcn_closure_norm(cl, num_relations: int):
    """Per-edge 1/|N_r(i)| weights of a ClosureLayer, 0 on its padding
    edges (static: compute once and pass as ``norm``). They equal the
    full graph's ``rgcn_norm`` on the closure's receivers, because a
    closure keeps all in-edges of every node it needs. Computed on the
    host, in fp32 as the JAX function's segment sum, and returned on the
    layer's device."""
    R = num_relations
    fused = cl.receivers.cpu().long() * R + cl.edge_type.cpu().long()
    m = cl.edge_mask.cpu().to(torch.float32)
    cnt = segment_sum(m, fused, cl.n_out * R)
    inv = torch.where(cnt > 0, 1.0 / cnt.clamp_min(1.0), 0.0)
    return (inv[fused] * m).to(cl.senders.device)


def rgcn_closure_op(cl, num_relations: int, mode: str,
                    in_channels: Optional[int] = None):
    """The fused operator of one closure layer: a rectangular
    ``PackedRgcnSpmm`` over the layer's real edges into its ``n_out``
    rows, on the layer's device, the mean weights of
    :func:`rgcn_closure_norm` baked in.

    ``mode="embed"``: the ``x=None`` layer; the senders are the global ids
    (clipped to the table, as the JAX path clips them) over the basis
    table's ``in_channels`` rows. ``mode="transform"``: a dense-``x``
    layer; the senders are local, over the layer's ``n_in`` rows."""
    if mode not in ("embed", "transform"):
        raise ValueError(f"mode must be 'embed' or 'transform', not {mode!r}")
    if mode == "embed" and in_channels is None:
        raise ValueError("mode='embed' needs in_channels, the basis "
                         "table's row count")
    w = rgcn_closure_norm(cl, num_relations)
    e = cl.num_real_edges
    s_local, s_global, r, et = real_edges(cl)
    senders, src_rows = ((s_global, int(in_channels)) if mode == "embed"
                         else (s_local, cl.n_in))
    return PackedRgcnSpmm(senders, r, et, num_relations, cl.n_out,
                          weights=host_array(w)[:e], num_src_rows=src_rows,
                          device=cl.senders.device)
