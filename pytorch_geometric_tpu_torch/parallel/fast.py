"""The partitioned SpMM on the port's kernels.

Counterpart of ``pytorch_geometric_tpu/parallel/fast.py``
(``PartitionedSpmm``). Both parts of a rank's aggregation run the
port's kernels:

- the local edges (S x S): the JAX dense/sparse split, edges keyed by
  (dst window, src window) and the keys of at least ``dense_threshold``
  edges dense (window, window) blocks in ``compute_dtype``, multiplied
  by ``ops/block_spmm.py:_bmm_f32`` with fp32 output and summed by
  window through the segment-sum kernel; the sparse remainder one
  ``spmm_csr`` (``ops/block_spmm.py:BlockSpmm``, whose remainder is
  ``spmm_static``, the square form of ``spmm_bi_static``);
- the remote edges, from the (P * H) received rows into the S local
  rows: ``spmm_bi_static``.

The halo rows are cast to ``compute_dtype`` (bf16 by default) before
they cross, at the JAX rounding points: the kernels read x in that type
anyway, and the exchange moves half the bytes. ``apply`` runs in three
steps, each its own method: :meth:`send_rows`, :meth:`exchange` (the
all-to-all) and :meth:`combine`.

Unlike the JAX operator, no shape is common to the ranks: under
``shard_map`` every device runs one program and the tables pad to one
shape; here each rank runs its own program and holds only its own
tables (``ranks=``).
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.block_spmm import BlockSpmm
from pytorch_geometric_tpu_torch.ops.spmm import (
    pack_bipartite_tables, spmm_bi_static)
from pytorch_geometric_tpu_torch.parallel.mesh import all_to_all


class PartitionedSpmm:
    """out[r] = sum_e w_e x[src_e] across an edge partition.

    Host build (loader time), for the ranks this process serves::

        op = PartitionedSpmm(shards, w_local, w_remote, ranks=[rank])
        fn, consts = op.bind()                 # consts: {rank: tables}
        out = fn(consts[rank], x_local, group)     # in the rank

    ``w_local`` / ``w_remote`` are :func:`partition_graph`'s routed
    weights; ``ranks=None`` builds every rank's tables (one process
    holding all shards). Differentiable in ``x_local``."""

    def __init__(self, shards, w_local, w_remote, *, window: int = 1024,
                 dense_threshold: int = 1024,
                 compute_dtype=torch.bfloat16,
                 ranks: Optional[Iterable[int]] = None, device="cuda"):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        P = shards.num_devices
        S = shards.nodes_per_shard
        H = shards.halo_size
        self.shards = shards
        self.num_peers = P
        self.halo_size = H
        self.window = window
        self.compute_dtype = compute_dtype
        self.ranks = list(range(P)) if ranks is None else list(ranks)
        w_local = np.asarray(w_local, np.float32)
        w_remote = np.asarray(w_remote, np.float32)

        self._consts: Dict[int, dict] = {}
        self._fns = {}
        dense_edges = total_edges = 0
        self.num_dense_blocks = 0
        for p in range(P):
            lm = shards.loc_mask[p]
            rm = shards.rem_mask[p]
            total_edges += int(lm.sum() + rm.sum())
            if p not in self.ranks:
                continue
            local = BlockSpmm(
                shards.loc_src_row[p][lm], shards.loc_dst[p][lm], S,
                w_local[p][lm], window=window,
                dense_threshold=dense_threshold,
                compute_dtype=compute_dtype, device=dev)
            dense_edges += round(local.dense_edge_frac * int(lm.sum()))
            self.num_dense_blocks = max(self.num_dense_blocks,
                                        local.num_dense_blocks)
            fn, lconsts = local.bind()
            consts = {"local": lconsts, "halo_send_idx": torch.from_numpy(
                shards.halo_send_idx[p].reshape(-1).astype(np.int64)).to(dev)}
            # built even without remote edges: the exchange's backward
            # runs on every rank only if every output reads the rows
            rs = (shards.rem_owner[p][rm].astype(np.int64) * H
                  + shards.rem_slot[p][rm])
            geom, consts["remote"] = pack_bipartite_tables(
                rs, shards.rem_dst[p][rm], P * H, S, w_remote[p][rm],
                compute_dtype=compute_dtype, device=dev)
            self._fns[p] = (fn, geom)
            consts["rank"] = p
            self._consts[p] = consts
        #: the dense share of the served ranks' local edges over every
        #: rank's real edges (the JAX figure when every rank is served)
        self.dense_edge_frac = dense_edges / max(total_edges, 1)

    def device_consts(self) -> Dict[int, dict]:
        """``{rank: that rank's tables}`` on the device."""
        return self._consts

    def send_rows(self, consts, x_local):
        """(P, H, F) send buffer in ``compute_dtype``: row q the rows peer
        q needs from this rank."""
        F = x_local.shape[1]
        return x_local[consts["halo_send_idx"]].to(
            self.compute_dtype).reshape(self.num_peers, self.halo_size, F)

    @staticmethod
    def exchange(send_buf, group=None):
        """The all-to-all: row q of the result came from peer q."""
        return all_to_all(send_buf, group)

    def combine(self, consts, x_local, recv):
        """The local part over ``x_local`` plus the remote part over the
        received (P, H, F) rows; fp32 (S, F)."""
        fn, geom = self._fns[consts["rank"]]
        flat = recv.reshape(self.num_peers * self.halo_size, recv.shape[-1])
        return fn(consts["local"], x_local) + spmm_bi_static(
            geom, consts["remote"], flat)

    def apply(self, consts, x_local, group=None):
        """This rank's aggregation: send, exchange, combine."""
        recv = self.exchange(self.send_rows(consts, x_local), group)
        return self.combine(consts, x_local, recv)

    def bind(self) -> Tuple:
        """``(apply_fn, consts)``: ``apply_fn(consts[rank], x_local,
        group)`` in the rank."""
        return self.apply, self._consts
