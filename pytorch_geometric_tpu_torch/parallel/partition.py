"""Edge-partitioned graphs with halo exchange.

Counterpart of ``pytorch_geometric_tpu/parallel/partition.py``. A graph
too large for one card is node-partitioned: rank p owns a contiguous
block of the (optionally RCM-relabelled) node ids and the edges its
block receives; the boundary ("halo") sender rows are exchanged before
the aggregation of the remote edges.

Host side (numpy): :func:`partition_graph` builds the edge shards and
halo tables, the JAX package's numbers exactly (one sort over the edges,
one unique over the remote edges; RCM through ``utils/reorder.py``).

Rank side, on this rank's slice of the tables (``GraphShards.
rank_tables``) and a process group:

- ``halo_spmm`` (all-to-all of the per-pair halo rows),
  ``boundary_spmm`` (all-gather of each rank's boundary union),
  ``allgather_spmm`` (all-gather of every shard), ``halo_spmm_max`` and
  ``halo_spmm_mean``: gathers and segment sums in plain PyTorch, as the
  JAX package leaves them to XLA; no trainer calls them;
- ``halo_rgcn`` and ``halo_gat``, which lie on the trainers' paths, run
  the port's kernels: one ``spmm_csr`` over a relation-major CSR of
  ``R * S`` rows whose sources are ``[x_local; received rows]``, and the
  packed GAT over a square CSR of those ``S + P * H`` rows. Their
  operators are built on the host from the tables once
  (:func:`halo_rgcn_operator`, :func:`halo_gat_operator`) and passed as
  ``op=``; a call without one builds it. On CPU tensors the kernels'
  wrappers compute their plain versions.

Every exchange is ``mesh.all_to_all`` (or an all-gather) on ``group``,
differentiable, so a whole train step runs through them.
"""

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.packed_gat import (
    PackedFlashGat, packed_gat_bwd, packed_gat_fwd)
from pytorch_geometric_tpu_torch.ops.segment import segment_sum
from pytorch_geometric_tpu_torch.ops.spmm import (
    pack_bipartite_tables, spmm_bi_static)
from pytorch_geometric_tpu_torch.parallel.mesh import (
    all_gather, all_max, all_to_all)


def _cdiv(a, b):
    return -(-a // b)


#: The tables a rank reads, in ``GraphShards.device_arrays``' order.
TABLES = ("loc_src_row", "loc_dst", "loc_mask", "rem_owner", "rem_slot",
          "rem_bslot", "rem_src_row", "rem_dst", "rem_mask",
          "halo_send_idx", "boundary_send_idx")


@dataclass(frozen=True)
class GraphShards:
    """Static edge partition over P ranks (every array stacked on a
    leading P axis). Relabelled node g lives on rank g // S at local row
    g % S; ``perm`` maps new id -> original id, and :meth:`shard_nodes`
    / :meth:`unshard_nodes` apply it. Edges are LOCAL (sender on the same
    rank) or REMOTE."""

    num_devices: int
    nodes_per_shard: int
    halo_size: int          # per-(q, p) halo row budget (all_to_all)
    boundary_size: int      # per-q boundary union budget (all_gather)
    num_local_edges: int    # padded per-rank local edge count
    num_remote_edges: int
    perm: np.ndarray = field(repr=False)            # (N,) new -> old
    loc_src_row: np.ndarray = field(repr=False)     # (P, El)
    loc_dst: np.ndarray = field(repr=False)
    loc_mask: np.ndarray = field(repr=False)
    rem_owner: np.ndarray = field(repr=False)       # (P, Er) sender's rank
    rem_slot: np.ndarray = field(repr=False)        # slot in (q->p) halo
    rem_bslot: np.ndarray = field(repr=False)       # slot in q's boundary
    rem_src_row: np.ndarray = field(repr=False)     # owner-local row
    rem_dst: np.ndarray = field(repr=False)
    rem_mask: np.ndarray = field(repr=False)
    halo_send_idx: np.ndarray = field(repr=False)   # (P, P, H)
    halo_send_mask: np.ndarray = field(repr=False)
    boundary_send_idx: np.ndarray = field(repr=False)   # (P, B)
    boundary_send_mask: np.ndarray = field(repr=False)

    def device_arrays(self, device="cuda"):
        """Every rank's tables, stacked (P, ...), as tensors on
        ``device``."""
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(
            getattr(self, k))).to(dev) for k in TABLES}

    def rank_tables(self, rank: int, device="cuda"):
        """Rank ``rank``'s slice of the tables on ``device``: what the
        rank-side functions read."""
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        return {k: torch.from_numpy(np.ascontiguousarray(
            getattr(self, k)[rank])).to(dev) for k in TABLES}

    def shard_nodes(self, x: np.ndarray) -> np.ndarray:
        """(N, ...) original order -> (P, S, ...) relabelled + padded."""
        P, S = self.num_devices, self.nodes_per_shard
        x = np.asarray(x)
        out = np.zeros((P * S,) + x.shape[1:], dtype=x.dtype)
        out[: len(self.perm)] = x[self.perm]
        return out.reshape((P, S) + x.shape[1:])

    def unshard_nodes(self, x, num_nodes: int):
        x = host_array(x)
        flat = x.reshape((-1,) + x.shape[2:])
        out = np.empty((num_nodes,) + flat.shape[1:], flat.dtype)
        out[self.perm] = flat[:num_nodes]
        return out

    def comm_stats(self, feature_dim: int, dtype_bytes: int = 4):
        """Per-exchange halo volume of this partition: the all-to-all
        moves the PADDED (P, H, F) send buffer from every rank, of which
        the masked rows are real. Bytes are per rank and exchange (one per
        aggregation; a K-layer forward makes K, its backward K more)."""
        P, H = self.num_devices, self.halo_size
        real_rows = self.halo_send_mask.sum(axis=(1, 2))     # (P,)
        padded_rows = P * H
        row_bytes = feature_dim * dtype_bytes
        loc = self.loc_mask.sum()
        rem = self.rem_mask.sum()
        return {
            "num_devices": P,
            "halo_rows_padded_per_dev": int(padded_rows),
            "halo_rows_real_max": int(real_rows.max()) if P else 0,
            "halo_rows_real_mean": float(real_rows.mean()) if P else 0.,
            "halo_bytes_padded_per_dev": int(padded_rows * row_bytes),
            "halo_bytes_real_max": int(real_rows.max() * row_bytes),
            "padding_fraction": float(
                1.0 - real_rows.mean() / max(padded_rows, 1)),
            "cut_fraction": float(rem / max(rem + loc, 1)),
        }


def _group_fill(values, group, num_groups, width, fill=0):
    """Scatter ``values`` (sorted by group) into (num_groups, width)."""
    counts = np.bincount(group, minlength=num_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(values)) - starts[group]
    out = np.full((num_groups, width), fill, values.dtype)
    out[group, pos] = values
    return out, counts, pos


def partition_graph(senders, receivers, num_nodes: int, num_devices: int,
                    edge_weights=None, locality: bool = True,
                    pad_multiple: int = 8
                    ) -> Tuple[GraphShards, Tuple[np.ndarray, np.ndarray]]:
    """Node-blocked edge partition (the receiver's owner gets the edge).

    ``locality=True`` relabels the nodes by reverse Cuthill-McKee first,
    so that contiguous blocks cut few edges. Returns ``(shards, (w_local,
    w_remote))``: the edge weights routed to their slots, (P, El) and
    (P, Er) float32 with zeros on the padding slots; an (E, K) stack of K
    weight vectors gives (K, P, El) / (K, P, Er), all sharing one slot
    assignment."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    w = np.ones(senders.shape[0], np.float32) if edge_weights is None \
        else np.asarray(edge_weights, np.float32)
    stacked = w.ndim == 2
    if not stacked:
        w = w[:, None]                      # (E, 1)
    K = w.shape[1]
    P = num_devices
    N = int(num_nodes)
    if locality and N > P:
        from pytorch_geometric_tpu_torch.utils.reorder import rcm_permutation
        perm = np.asarray(rcm_permutation(senders, receivers, N))
    else:
        perm = np.arange(N)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    s = inv[senders]
    r = inv[receivers]
    S = _cdiv(N, P)

    own_dst = (r // S).astype(np.int64)
    own_src = (s // S).astype(np.int64)
    is_local = own_src == own_dst

    def pad_w(n):
        return max(_cdiv(max(n, 1), pad_multiple) * pad_multiple, 1)

    # local edges: sorted by owner into (P, El)
    li = np.flatnonzero(is_local)
    lorder = li[np.argsort(own_dst[li], kind="stable")]
    lgrp = own_dst[lorder]
    El = pad_w(int(np.bincount(lgrp, minlength=P).max()) if len(lorder)
               else 1)
    loc_src_row, _, lpos = _group_fill((s[lorder] % S).astype(np.int32),
                                       lgrp, P, El)
    loc_dst = np.zeros((P, El), np.int32)
    loc_dst[lgrp, lpos] = (r[lorder] % S).astype(np.int32)
    loc_mask = np.zeros((P, El), bool)
    loc_mask[lgrp, lpos] = True
    w_local = np.zeros((K, P, El), np.float32)
    w_local[:, lgrp, lpos] = w[lorder].T

    # remote edges: sorted by (dst owner, src), one unique pass
    ri = np.flatnonzero(~is_local)
    rkey = own_dst[ri] * N + s[ri]
    rorder = ri[np.argsort(rkey, kind="stable")]
    rp = own_dst[rorder]
    rs = s[rorder]

    uniq, einv = np.unique(rp * N + rs, return_inverse=True)
    up = uniq // N                   # dst owner per unique halo row
    us = uniq % N                    # global src id
    uq = us // S                     # src owner
    # uniq is sorted by (p, s) and q is monotone in s, so the (p, q)
    # groups are contiguous runs
    pair = up * P + uq
    pair_change = np.concatenate([[True], pair[1:] != pair[:-1]])
    run_start = np.maximum.accumulate(
        np.where(pair_change, np.arange(len(pair)), 0))
    uslot = np.arange(len(pair)) - run_start
    H = pad_w(int(uslot.max()) + 1 if len(uslot) else 1)

    halo_send_idx = np.zeros((P, P, H), np.int32)
    halo_send_mask = np.zeros((P, P, H), bool)
    halo_send_idx[uq, up, uslot] = (us % S).astype(np.int32)
    halo_send_mask[uq, up, uslot] = True

    # boundary union per source rank q
    bsrc = np.unique(us)
    bq = bsrc // S
    bstart = np.concatenate(
        [[0], np.cumsum(np.bincount(bq, minlength=P))[:-1]])
    bslot_of = np.arange(len(bsrc)) - bstart[bq]
    B = pad_w(int(np.bincount(bq, minlength=P).max()) if len(bsrc)
              else 1)
    boundary_send_idx = np.zeros((P, B), np.int32)
    boundary_send_mask = np.zeros((P, B), bool)
    boundary_send_idx[bq, bslot_of] = (bsrc % S).astype(np.int32)
    boundary_send_mask[bq, bslot_of] = True
    ub = bslot_of[np.searchsorted(bsrc, us)]

    Er = pad_w(int(np.bincount(rp, minlength=P).max()) if len(rorder)
               else 1)
    rem_owner, _, rpos = _group_fill(uq[einv].astype(np.int32), rp, P, Er)
    rem_slot = np.zeros((P, Er), np.int32)
    rem_slot[rp, rpos] = uslot[einv].astype(np.int32)
    rem_bslot = np.zeros((P, Er), np.int32)
    rem_bslot[rp, rpos] = ub[einv].astype(np.int32)
    rem_src_row = np.zeros((P, Er), np.int32)
    rem_src_row[rp, rpos] = (rs % S).astype(np.int32)
    rem_dst = np.zeros((P, Er), np.int32)
    rem_dst[rp, rpos] = (r[rorder] % S).astype(np.int32)
    rem_mask = np.zeros((P, Er), bool)
    rem_mask[rp, rpos] = True
    w_remote = np.zeros((K, P, Er), np.float32)
    w_remote[:, rp, rpos] = w[rorder].T
    if not stacked:
        w_local, w_remote = w_local[0], w_remote[0]

    shards = GraphShards(
        num_devices=P, nodes_per_shard=S, halo_size=H, boundary_size=B,
        num_local_edges=El, num_remote_edges=Er, perm=perm,
        loc_src_row=loc_src_row, loc_dst=loc_dst, loc_mask=loc_mask,
        rem_owner=rem_owner, rem_slot=rem_slot, rem_bslot=rem_bslot,
        rem_src_row=rem_src_row, rem_dst=rem_dst, rem_mask=rem_mask,
        halo_send_idx=halo_send_idx, halo_send_mask=halo_send_mask,
        boundary_send_idx=boundary_send_idx,
        boundary_send_mask=boundary_send_mask)
    return shards, (w_local, w_remote)


# --- rank side -------------------------------------------------------------

def _local_part(x_local, w_local, tables, S):
    msgs = x_local[tables["loc_src_row"].long()] * w_local[:, None]
    return segment_sum(msgs, tables["loc_dst"], S)


def halo_send(x_local, tables, halo_size: int, num_peers: int):
    """(num_peers, halo_size, F) send buffer: row q holds the rows peer q
    needs from this rank (padding slots repeat row 0 and are never
    read)."""
    F = x_local.shape[1]
    return x_local[tables["halo_send_idx"].reshape(-1).long()].reshape(
        num_peers, halo_size, F)


def _halo_rows(x_local, tables, group, halo_size: int, num_peers: int):
    """The per-pair halo rows through one all-to-all: the flat
    (num_peers * halo_size, F) receive buffer, and each remote edge's row
    in it."""
    F = x_local.shape[1]
    recv = all_to_all(halo_send(x_local, tables, halo_size, num_peers),
                      group)
    src = tables["rem_owner"].long() * halo_size + tables["rem_slot"].long()
    return recv.reshape(num_peers * halo_size, F), src


def halo_spmm(x_local, weights, tables, group, halo_size: int,
              num_peers: int):
    """out[r] = sum_e w_e x[src_e]; the remote rows through the
    all-to-all of the per-pair halo lists. ``weights`` = (w_local,
    w_remote), this rank's rows."""
    S = x_local.shape[0]
    w_local, w_remote = weights
    flat, src = _halo_rows(x_local, tables, group, halo_size, num_peers)
    out = _local_part(x_local, w_local, tables, S)
    msgs = flat[src] * w_remote[:, None]
    return out + segment_sum(msgs, tables["rem_dst"], S)


def boundary_spmm(x_local, weights, tables, group, boundary_size: int):
    """The remote rows through an all-gather of each rank's boundary
    union: a buffer of O(P * B) rows instead of O(P^2 * H)."""
    S, F = x_local.shape
    w_local, w_remote = weights
    send_buf = x_local[tables["boundary_send_idx"].long()]
    flat = all_gather(send_buf, group).reshape(-1, F)
    out = _local_part(x_local, w_local, tables, S)
    src = tables["rem_owner"].long() * boundary_size \
        + tables["rem_bslot"].long()
    msgs = flat[src] * w_remote[:, None]
    return out + segment_sum(msgs, tables["rem_dst"], S)


def allgather_spmm(x_local, weights, tables, group):
    """All-gather every shard, then the local SpMM: for a dense cut."""
    S, F = x_local.shape
    w_local, w_remote = weights
    flat = all_gather(x_local, group).reshape(-1, F)
    out = _local_part(x_local, w_local, tables, S)
    src = tables["rem_owner"].long() * S + tables["rem_src_row"].long()
    msgs = flat[src] * w_remote[:, None]
    return out + segment_sum(msgs, tables["rem_dst"], S)


def _masked_max(msgs, mask, dst, S):
    msgs = torch.where(mask[:, None], msgs, float("-inf"))
    out = msgs.new_full((S,) + tuple(msgs.shape[1:]), float("-inf"))
    idx = dst.long()[:, None].expand_as(msgs)
    return out.scatter_reduce(0, idx, msgs, "amax", include_self=True)


def halo_spmm_max(x_local, tables, group, halo_size: int, num_peers: int):
    """out[r] = max_e x[src_e] across the partition (``aggr="max"``);
    padding edges count as -inf, and a receiver with no edge anywhere
    gets 0, as the single-device segment max."""
    S = x_local.shape[0]
    out = _masked_max(x_local[tables["loc_src_row"].long()],
                      tables["loc_mask"], tables["loc_dst"], S)
    flat, src = _halo_rows(x_local, tables, group, halo_size, num_peers)
    out = torch.maximum(out, _masked_max(flat[src], tables["rem_mask"],
                                         tables["rem_dst"], S))
    return torch.where(torch.isneginf(out), 0.0, out)


def halo_spmm_mean(x_local, weights, tables, group, halo_size: int,
                   num_peers: int):
    """Mean across the partition: the halo sum over the per-receiver
    count of weighted edges (padding edges weigh 0)."""
    num = halo_spmm(x_local, weights, tables, group, halo_size, num_peers)
    ones = x_local.new_ones((x_local.shape[0], 1))
    den = halo_spmm(ones, weights, tables, group, halo_size, num_peers)
    return num / den.clamp_min(1e-12)


def _sources(tables, halo_size: int, S: int, mask_key: str):
    """(sender row in ``[x_local; received rows]``, receiver row) of the
    real local or remote edges, on the host."""
    if mask_key == "loc_mask":
        m = host_array(tables["loc_mask"]).astype(bool)
        src = host_array(tables["loc_src_row"]).astype(np.int64)[m]
        dst = host_array(tables["loc_dst"]).astype(np.int64)[m]
    else:
        m = host_array(tables["rem_mask"]).astype(bool)
        src = S + (host_array(tables["rem_owner"]).astype(np.int64)
                   * halo_size + host_array(tables["rem_slot"]))[m]
        dst = host_array(tables["rem_dst"]).astype(np.int64)[m]
    return src, dst, m


def halo_rgcn_operator(tables, rel_weights, halo_size: int,
                       num_peers: int, num_nodes: int):
    """``(geom, consts)`` of :func:`spmm_bi_static` for :func:`halo_rgcn`:
    the edges of every relation with a nonzero weight, from row ``src`` of
    ``[x_local; received rows]`` (``num_nodes + num_peers * halo_size``
    rows) into row ``relation * num_nodes + dst``, fp32, on the tables'
    device. Built on the host."""
    S, R = int(num_nodes), len(rel_weights)
    ls, ld, lm = _sources(tables, halo_size, S, "loc_mask")
    rs, rd, rm = _sources(tables, halo_size, S, "rem_mask")
    src, dst, w = [], [], []
    for rel, (wl, wr) in enumerate(rel_weights):
        for s_, d_, wv in ((ls, ld, host_array(wl)[lm]),
                           (rs, rd, host_array(wr)[rm])):
            keep = wv != 0
            src.append(s_[keep])
            dst.append(rel * S + d_[keep])
            w.append(wv[keep])
    device = tables["loc_dst"].device
    return pack_bipartite_tables(
        np.concatenate(src), np.concatenate(dst),
        S + num_peers * halo_size, R * S, np.concatenate(w),
        compute_dtype=torch.float32, device=device)


def halo_rgcn(x_local, basis, comb, rel_weights, tables, group,
              halo_size: int, num_peers: int, root=None, op=None):
    """Relational conv over the edge partition: out_i = sum_r sum_{j in
    N_r(i)} norm_e x_j W_r (+ x_i W_root), W_r = sum_b comb[r, b] B_b.

    ``rel_weights`` is one (w_local, w_remote) pair per relation (the
    norm masked to that relation's edges). The halo rows of x cross once;
    every relation's sum is then one ``spmm_csr`` over the relation-major
    CSR of ``op`` (:func:`halo_rgcn_operator`, built here when None), and
    the basis combine one product after the aggregation."""
    S = x_local.shape[0]
    if op is None:
        op = halo_rgcn_operator(tables, rel_weights, halo_size, num_peers,
                                S)
    recv = all_to_all(halo_send(x_local, tables, halo_size, num_peers),
                      group)
    return halo_rgcn_combine(x_local, recv, basis, comb, op, root)


def halo_rgcn_combine(x_local, recv, basis, comb, op, root=None):
    """:func:`halo_rgcn` after the exchange: ``recv`` (P, H, F) the
    received halo rows."""
    R = comb.shape[0]
    S, F = x_local.shape
    W = torch.einsum("rb,bfc->rfc", comb, basis)         # (R, F, C)
    x_all = torch.cat([x_local, recv.reshape(-1, F)])
    aggs = spmm_bi_static(op[0], op[1], x_all)
    out = torch.einsum("rsf,rfc->sc", aggs.reshape(R, S, F), W)
    if root is not None:
        out = out + x_local @ root
    return out


def halo_gat_operator(tables, halo_size: int, num_peers: int,
                      num_nodes: int) -> PackedFlashGat:
    """The packed-GAT operator of :func:`halo_gat`: a square graph of the
    ``num_nodes + num_peers * halo_size`` rows of ``[local; received]``
    whose real local and remote edges all point into the first
    ``num_nodes`` rows, sorted stably by receiver (local edges first);
    the received rows receive nothing. On the tables' device."""
    S = int(num_nodes)
    ls, ld, _ = _sources(tables, halo_size, S, "loc_mask")
    rs, rd, _ = _sources(tables, halo_size, S, "rem_mask")
    s = np.concatenate([ls, rs])
    r = np.concatenate([ld, rd])
    order = np.argsort(r, kind="stable")
    return PackedFlashGat(senders=s[order], receivers=r[order],
                          num_nodes=S + num_peers * halo_size,
                          device=tables["loc_dst"].device)


class _HaloGatRaw(torch.autograd.Function):
    """(d, s, h) -> the packed GAT's raw num‖den with the shift ``m``
    given (the max of a_src over every rank); no dropout."""

    @staticmethod
    def forward(ctx, d, s, h, m, op):
        d, s, h = (t.contiguous() for t in (d, s, h))
        seed = torch.zeros(1, dtype=torch.int32, device=d.device)
        ctx.save_for_backward(d, s, h, m, seed)
        ctx.op = op
        return packed_gat_fwd(op.fwd, d, s, h, m, seed, 0.0, op.slope)

    @staticmethod
    def backward(ctx, g):
        d, s, h, m, seed = ctx.saved_tensors
        op = ctx.op
        dd, ds, dh = packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m,
                                    seed, g.contiguous(), 0.0, op.slope)
        return dd, ds, dh, None, None


def halo_gat(h_local, a_src_local, a_dst_local, tables, group,
             halo_size: int, num_peers: int, heads: int,
             negative_slope: float = 0.2, op=None):
    """GAT attention over the edge partition: ``h_local`` (S, H*C)
    per-head features, ``a_src_local`` / ``a_dst_local`` (S, H) half
    logits; returns (S, H*C), the softmax applied.

    The shift of receiver i is leaky(max_j a_src_j + a_dst_i), with the
    max over every rank: one scalar max per head (``all_max``), no
    gradient, and it bounds every incoming logit. a_src rides with h in
    one fp32 exchange of the halo rows. The attention is then one packed
    GAT over ``op`` (:func:`halo_gat_operator`, built here when None)
    with dropout 0 (the JAX path applies none); a receiver whose sum
    underflows returns 0."""
    if op is None:
        op = halo_gat_operator(tables, halo_size, num_peers,
                               h_local.shape[0])
    if op.slope != float(negative_slope):
        raise ValueError(f"the operator's slope is {op.slope}, the call's "
                         f"{negative_slope}")
    m = all_max(a_src_local.amax(dim=0), group)                   # (H,)
    payload = torch.cat([a_src_local, h_local], dim=1)
    recv = all_to_all(halo_send(payload, tables, halo_size, num_peers),
                      group)
    return halo_gat_combine(h_local, a_src_local, a_dst_local, recv, m,
                            op, heads)


def halo_gat_combine(h_local, a_src_local, a_dst_local, recv, m, op,
                     heads: int):
    """:func:`halo_gat` after the exchange: ``recv`` (P, H_halo, heads +
    H*C) the received [a_src | h] rows, ``m`` (heads,) the max of a_src
    over every rank."""
    S = h_local.shape[0]
    H = heads
    C = h_local.shape[1] // H
    flat = recv.reshape(-1, recv.shape[-1])
    s_all = torch.cat([a_src_local, flat[:, :H]])
    h_all = torch.cat([h_local, flat[:, H:]])
    d_all = torch.cat([a_dst_local, a_dst_local.new_zeros(
        (flat.shape[0], H))])
    acc = _HaloGatRaw.apply(d_all, s_all, h_all,
                            m.detach().float().contiguous(), op)[:S]
    num, den = acc[:, :H * C], acc[:, H * C:]
    den = torch.where(den < 1e-16, 1.0, den)
    return (num.reshape(S, H, C) / den[:, :, None]).reshape(S, H * C)
