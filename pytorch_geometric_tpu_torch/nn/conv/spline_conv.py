"""Spline-based convolution (Fey et al., SplineCNN).

Counterpart of ``pytorch_geometric_tpu/nn/conv/spline_conv.py``
(reference: ``torch_geometric.nn.SplineConv``). Per edge, the
pseudo-coordinates u in [0, 1]^D pick (degree + 1)^D corners of the
kernel grid with B-spline weights b (:func:`spline_basis`); the message
is ``x_j @ sum_s b_s W[k_s]``; then the root weight and the bias.

The JAX module sums ``b x_j`` into an (N·K, F_in) accumulator by the
fused segment id ``receiver·K + kernel index`` and contracts it with
the (K·F_in, C) weight in one matrix product. That accumulator is a
weighted SpMM with N·K rows and N columns. The pseudo-coordinates are
data, so the operator is built on the host once per graph and bound:

- :func:`spline_operator`: the one rectangular operator, row
  ``receiver·K + kernel index``, column ``sender``, value the B-spline
  weight (``ops/spmm.py:spmm_bi_static``); its (N·K, F_in) output
  reshapes to (N, K·F_in) as the JAX accumulator does. One
  ``spmm_csr`` launch a forward, one for ``dx``. Pass it as
  ``spline_op``.
- :func:`spline_operators`: the accumulator split by kernel index into K
  square operators, whose outputs are concatenated along the features:
  K launches a forward. Pass the list as ``spline_fns``.
- :func:`static_spline_operator`: :func:`spline_operator`'s form in
  buffers of a loader's budget (``ops/spmm.py:StaticBiSpmm``, (edge
  budget x (degree + 1)^dim) slots a direction), loaded with each
  batch's operator, for a captured step. Pass it as ``spline_op``.

Without either, on the CPU only, the JAX module's fused segment sum.
"""

import functools
import itertools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import uniform
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, StaticBiSpmm, pack_bipartite_tables, spmm_bi_static)
from pytorch_geometric_tpu_torch.utils.repeat import repeat


def _bspline_blend(frac, k: int, degree: int):
    """Uniform B-spline blending function for support offset ``k``:
    degree 1 linear interpolation, degrees 2 and 3 the quadratic and
    cubic pieces (torch-spline-conv's basis)."""
    f = frac
    if degree == 1:
        return 1.0 - f if k == 0 else f
    if degree == 2:
        if k == 0:
            return 0.5 * (1.0 - f) ** 2
        if k == 1:
            return -f * f + f + 0.5
        return 0.5 * f * f
    if degree == 3:
        if k == 0:
            return (1.0 - f) ** 3 / 6.0
        if k == 1:
            return (3.0 * f ** 3 - 6.0 * f * f + 4.0) / 6.0
        if k == 2:
            return (-3.0 * f ** 3 + 3.0 * f * f + 3.0 * f + 1.0) / 6.0
        return f ** 3 / 6.0
    raise NotImplementedError(f"B-spline degree {degree} (1-3 supported)")


def spline_basis(pseudo, kernel_size, is_open_spline, degree: int = 1):
    """Uniform B-spline basis of degree 1, 2 or 3.

    ``pseudo`` (E, D) in [0, 1]. Returns ``(weights (E, (degree+1)^D),
    indices (E, (degree+1)^D))``, the indices flattened row-major over
    ``kernel_size``. Open splines clip the top support index (its weight
    is exactly 0 at pseudo == 1); closed ones wrap."""
    E, D = pseudo.shape
    m = degree
    ks = [int(k) for k in kernel_size]
    open_ = [int(o) for o in is_open_spline]
    p = torch.stack([pseudo[:, d] * float(ks[d] - m * open_[d])
                     for d in range(D)], dim=1)
    k0 = torch.floor(p).to(torch.int32)
    frac = p - k0
    strides = [math.prod(ks[d + 1:]) for d in range(D)]
    w_list, i_list = [], []
    for combo in itertools.product(range(m + 1), repeat=D):
        w = torch.ones((E,), dtype=pseudo.dtype, device=pseudo.device)
        idx = torch.zeros((E,), dtype=torch.int32, device=pseudo.device)
        for d, c in enumerate(combo):
            kd = k0[:, d] + c
            kd = kd.clamp(0, ks[d] - 1) if open_[d] > 0 else \
                torch.remainder(kd, ks[d])
            w = w * _bspline_blend(frac[:, d], c, m)
            idx = idx + kd * strides[d]
        w_list.append(w)
        i_list.append(idx)
    return torch.stack(w_list, dim=1), torch.stack(i_list, dim=1)


def _spline_shape(dim, kernel_size, is_open_spline):
    ks = repeat(kernel_size, dim)
    return ks, math.prod(ks), repeat(1 if is_open_spline else 0, dim)


def _spline_entries(graph: Graph, dim: int, kernel_size, is_open_spline,
                    degree, pseudo):
    """The accumulator's (edge, corner) entries as host arrays:
    ``(senders, receivers, kernel indices, basis weights, K)``, without
    padding edges and entries of weight 0 (they add nothing)."""
    ks, K, open_ = _spline_shape(dim, kernel_size, is_open_spline)
    pseudo = graph.edge_attr if pseudo is None else pseudo
    b, idx = spline_basis(pseudo.float(), ks, open_, degree)
    b = torch.where(graph.real_edge_mask()[:, None], b, 0.0)
    S = b.shape[1]
    b, idx = host_array(b).reshape(-1), host_array(idx).reshape(-1)
    keep = b != 0
    s = np.repeat(host_array(graph.senders), S)[keep]
    r = np.repeat(host_array(graph.receivers), S)[keep]
    return s, r, idx[keep], b[keep], K


def spline_edge_sets(graph: Graph, dim: int, kernel_size,
                     is_open_spline: bool = True, degree: int = 1,
                     pseudo=None):
    """The accumulator's entries split by kernel index, as host arrays:
    entry k is ``(senders, receivers, basis weights)`` of the (edge,
    corner) pairs whose kernel index is k. ``pseudo`` defaults to
    ``graph.edge_attr``. Padding edges and entries of weight 0 are left
    out (they add nothing)."""
    s, r, idx, b, K = _spline_entries(graph, dim, kernel_size,
                                      is_open_spline, degree, pseudo)
    return [(s[sel], r[sel], b[sel]) for sel in (idx == k for k in range(K))]


def spline_operators(graph: Graph, dim: int, kernel_size,
                     is_open_spline: bool = True, degree: int = 1,
                     pseudo=None):
    """The K bound SpMMs of a ``SplineConv`` of this configuration on
    ``graph``, on its device, over :func:`spline_edge_sets`: pass the list
    as ``spline_fns``. Built on the host."""
    return [SpmmOperator(s, r, graph.num_nodes, device=graph.device).bind(b)
            for s, r, b in spline_edge_sets(graph, dim, kernel_size,
                                            is_open_spline, degree, pseudo)]


def spline_operator(graph: Graph, dim: int, kernel_size,
                    is_open_spline: bool = True, degree: int = 1,
                    pseudo=None, compute_dtype=torch.float32, device=None):
    """The accumulator of a ``SplineConv`` of this configuration on
    ``graph`` as one bound rectangular SpMM, ``x (N, F) -> (N·K, F)``, on
    ``device`` (default: the graph's): pass it as ``spline_op``. Built on
    the host in one pass over the fused row id ``receiver·K + kernel
    index``; within a row the entries keep their (edge, corner) order.
    Differentiable in x."""
    s, r, idx, b, K = _spline_entries(graph, dim, kernel_size,
                                      is_open_spline, degree, pseudo)
    n = graph.num_nodes
    geom, consts = pack_bipartite_tables(
        s, r.astype(np.int64) * K + idx, n, n * K, b,
        compute_dtype=compute_dtype,
        device=graph.device if device is None else device)
    return functools.partial(spmm_bi_static, geom, consts)


def static_spline_operator(num_nodes: int, num_edges: int, dim: int,
                           kernel_size, is_open_spline: bool = True,
                           degree: int = 1, compute_dtype=torch.float32,
                           device="cuda") -> StaticBiSpmm:
    """Static buffers of :func:`spline_operator` for graphs of
    ``num_nodes`` nodes and ``num_edges`` edge slots on ``device``: the
    forward CSR of N·K rows over N, its transpose, each with a slot for
    every (edge, corner) pair, and both value vectors. ``load`` copies a
    batch's :func:`spline_operator` in; the call is the operator's."""
    _, K, _ = _spline_shape(dim, kernel_size, is_open_spline)
    return StaticBiSpmm(num_nodes, num_nodes * K,
                        num_edges * (degree + 1) ** dim,
                        compute_dtype=compute_dtype, device=device)


class SplineConv(nn.Module):
    """``weight`` (K, F_in, C), ``root`` (F_in, C), ``bias`` (C,), drawn
    as the JAX module draws them (PyG's fan-based uniform)."""

    def __init__(self, in_channels: int, out_channels: int, dim: int,
                 kernel_size, is_open_spline: bool = True, degree: int = 1,
                 aggr: str = "add", root_weight: bool = True,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggr not in ("add", "sum", "mean"):
            raise NotImplementedError(f"aggr={aggr}")
        self.dim, self.kernel_size = dim, kernel_size
        self.is_open_spline, self.degree, self.aggr = (is_open_spline,
                                                       degree, aggr)
        F, C = in_channels, out_channels
        _, K, _ = _spline_shape(dim, kernel_size, is_open_spline)
        self.weight = nn.Parameter(uniform(F * K)((K, F, C), generator))
        self.root = nn.Parameter(uniform(F)((F, C), generator)) \
            if root_weight else None
        self.bias = nn.Parameter(uniform(F)((C,), generator)) \
            if use_bias else None

    def forward(self, graph: Graph, x, pseudo=None, spline_fns=None,
                spline_op=None):
        N, F = graph.num_nodes, x.shape[-1]
        ks, K, open_ = _spline_shape(self.dim, self.kernel_size,
                                     self.is_open_spline)
        em = graph.real_edge_mask()
        if spline_op is not None:
            A = spline_op(x).reshape(N, K * F)
        elif spline_fns is not None:
            A = torch.cat([fn(x) for fn in spline_fns], dim=1)
        else:
            require_cpu(x, "SplineConv",
                        "spline_op (spline_operator) or spline_fns")
            pseudo = graph.edge_attr if pseudo is None else pseudo
            b, idx = spline_basis(pseudo, ks, open_, self.degree)
            b = torch.where(em[:, None], b, 0.0)
            x_j = x.index_select(0, graph.senders.long())
            fused = (graph.receivers.long()[:, None] * K + idx).reshape(-1)
            vals = (x_j[:, None, :] * b[:, :, None]).reshape(-1, F)
            A = segment_sum(vals, fused, N * K).reshape(N, K * F)
        out = A @ self.weight.reshape(K * F, -1)
        if self.aggr == "mean":
            deg = segment_sum(em.to(out.dtype), graph.receivers, N)
            out = out / deg.clamp_min(1.0)[:, None]
        if self.root is not None:
            out = out + x @ self.root
        if self.bias is not None:
            out = out + self.bias
        return out
