"""Distributed graph training through the public nn API.

Counterpart of ``pytorch_geometric_tpu/parallel/api.py``:

- :class:`GraphPartition`, host side: partitions the self-loop-augmented
  edge list over P ranks (remove-then-add loops), routes the GCN-norm,
  the mean and the R per-relation means through ONE
  :func:`partition_graph` call (so all share one slot assignment), and
  builds, for the ranks this process serves, a :class:`PartitionedSpmm`
  per weighting and the ``halo_gat`` / ``halo_rgcn`` operators;
- :class:`ShardCtx`, one rank's view, passed to ``GCNConv``,
  ``SAGEConv``, ``GATConv`` and ``RGCNConv`` as ``shard_ctx=``;
- :meth:`GraphPartition.make_train_step`, the step of a Dist model: the
  local loss ``num / sum_ranks(den)`` with the denominator detached,
  then the gradients and the loss summed over the ranks in rank order
  (``mesh.ordered_sum``), the JAX step's semantics.

Each rank runs its own program: the JAX version's ``shard_map`` over a
mesh becomes one process per rank (``mesh.RankPool``), and a rank holds
only its own tables. The node arrays are the (P, S, ...) stacks of
:meth:`shard_nodes`; a rank reads its row.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from pytorch_geometric_tpu_torch.parallel.fast import PartitionedSpmm
from pytorch_geometric_tpu_torch.parallel.mesh import (
    all_gather_rows, make_mesh, ordered_sum)
from pytorch_geometric_tpu_torch.parallel.partition import (
    GraphShards, halo_gat_operator, halo_rgcn_operator, partition_graph)


@dataclass
class ShardCtx:
    """One rank's view of the partition."""

    group: Any
    num_peers: int
    halo_size: int
    nodes_per_shard: int
    ops: Dict[str, PartitionedSpmm]     # host-built operators
    consts: Dict[str, Any]              # this rank's tables

    def aggregate(self, which: str, h):
        """The partitioned SpMM of the named static weighting."""
        return self.ops[which].apply(self.consts[which], h, self.group)


class GraphPartition:
    """Host-side partition and operator factory.

    Usage, in every rank of a group (``mesh.RankPool``)::

        part = GraphPartition(senders, receivers, num_nodes, P)
        model = part.init_model(DistGCN(F, hidden, classes), x_sh, gen)
        step = part.make_train_step(model, tx, loss_fn)
        opt = step.optimizer
        model, opt, loss = step(model, opt, x_sh, y_sh, m_sh, gen)

    ``devices`` are the global ranks of the partition's mesh (default:
    the first P). With a group initialised, the operators are built for
    this process's rank in it (none when it is outside); without one,
    for ``ranks`` (default: every rank), for a process that holds every
    shard. ``device``: where tensors live (a rank's card by default).
    """

    WEIGHTINGS = ("gcn", "mean")

    def __init__(self, senders, receivers, num_nodes: int,
                 num_devices: int, *, locality: bool = True,
                 window: int = 1024, dense_threshold: int = 1024,
                 add_self_loops: bool = True,
                 edge_type=None, num_relations: int = 0,
                 compute_dtype=torch.bfloat16, devices=None,
                 ranks: Optional[Iterable[int]] = None, device="cuda"):
        from pytorch_geometric_tpu_torch.parallel.mesh import rank_device

        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        N = int(num_nodes)
        self.num_nodes = N
        self.num_devices = P = int(num_devices)
        self.axis = "graph"
        self.num_relations = R = int(num_relations)
        self.compute_dtype = compute_dtype
        self.device = rank_device(device)
        if add_self_loops:
            # remove-then-add: an edge list that carries self loops gets
            # no double-counted self term (nor a duplicate GAT slot)
            keep = senders != receivers
            if not bool(keep.all()):
                senders, receivers = senders[keep], receivers[keep]
                if edge_type is not None:
                    edge_type = np.asarray(edge_type, np.int64)[keep]
            loop = np.arange(N, dtype=np.int64)
            s_aug = np.concatenate([senders, loop])
            r_aug = np.concatenate([receivers, loop])
        else:
            s_aug, r_aug = senders, receivers
        deg = np.bincount(r_aug, minlength=N).astype(np.float64)
        dis = np.where(deg > 0, np.maximum(deg, 1e-12) ** -0.5, 0.0)
        w_gcn = (dis[s_aug] * dis[r_aug]).astype(np.float32)
        w_mean = (1.0 / np.maximum(deg[r_aug], 1.0)).astype(np.float32)

        # every weighting rides ONE partition_graph call as an (E, K)
        # stack, so all share one slot assignment by construction
        cols = [w_gcn, w_mean]
        if R:
            et = np.asarray(edge_type, np.int64)
            # per-(relation, receiver) mean norm on the real edges; the
            # appended loops weigh 0 in every relation (the root term)
            fused = receivers * R + et
            cnt = np.bincount(fused, minlength=N * R)
            inv = np.where(cnt > 0, 1.0 / np.maximum(cnt, 1), 0.0)
            n_loops = N if add_self_loops else 0
            for rel in range(R):
                w_rel = np.where(et == rel, inv[fused], 0.0) \
                    .astype(np.float32)
                cols.append(np.concatenate(
                    [w_rel, np.zeros(n_loops, np.float32)]))
        wstack = np.stack(cols, axis=1)          # (E_aug, 2 + R)
        shards, (wl_all, wr_all) = partition_graph(
            s_aug, r_aug, N, P, edge_weights=wstack, locality=locality)
        self.shards: GraphShards = shards

        if dist.is_initialized():
            self.mesh = make_mesh((P,), (self.axis,), devices=devices)
            self.group = self.mesh.get_group(self.axis) \
                if self.mesh.get_coordinate() is not None else None
            self.ranks = [] if self.group is None \
                else [dist.get_rank(self.group)]
        else:
            self.mesh = self.group = None
            self.ranks = list(range(P)) if ranks is None else list(ranks)
        self.rank = self.ranks[0] if len(self.ranks) == 1 else None

        kw = dict(window=min(window, shards.nodes_per_shard),
                  dense_threshold=dense_threshold,
                  compute_dtype=compute_dtype, ranks=self.ranks,
                  device=self.device)
        self.ops = {
            "gcn": PartitionedSpmm(shards, wl_all[0], wr_all[0], **kw),
            "mean": PartitionedSpmm(shards, wl_all[1], wr_all[1], **kw),
        }
        S, H = shards.nodes_per_shard, shards.halo_size
        self._consts = {}
        for p in self.ranks:
            c = {k: op.device_consts()[p] for k, op in self.ops.items()}
            c["tables"] = shards.rank_tables(p, self.device)
            c["gat_op"] = halo_gat_operator(c["tables"], H, P, S)
            if R:
                c["rgcn_wl"] = torch.from_numpy(wl_all[2:, p]).to(
                    self.device)                              # (R, El)
                c["rgcn_wr"] = torch.from_numpy(wr_all[2:, p]).to(
                    self.device)
                c["rgcn_op"] = halo_rgcn_operator(
                    c["tables"], list(zip(wl_all[2:, p], wr_all[2:, p])),
                    H, P, S)
            self._consts[p] = c

    # ---- communication accounting -----------------------------------------

    def comm_stats(self, feature_dim: int, dtype_bytes: Optional[int] = None,
                   path: str = "spmm") -> Dict:
        """Per-exchange halo volume of one path (GraphShards.comm_stats),
        in the width that path moves: ``"spmm"`` (``PartitionedSpmm``, the
        convs' GCN and mean sums, and ``halo_rgcn``'s x rows in fp32 when
        ``dtype_bytes=4``) defaults to ``compute_dtype``'s (bf16: 2
        bytes), ``"gat"`` to fp32's 4, since ``halo_gat`` exchanges its
        [a_src | h] rows uncast (``feature_dim`` = heads + heads *
        channels). ``dtype_bytes`` overrides."""
        if path not in ("spmm", "gat"):
            raise ValueError(f"path must be 'spmm' or 'gat', got {path!r}")
        if dtype_bytes is None:
            dtype_bytes = 4 if path == "gat" else \
                torch.empty(0, dtype=self.compute_dtype).element_size()
        return self.shards.comm_stats(feature_dim, dtype_bytes)

    @staticmethod
    def predict_scaling(num_edges: int, feature_dim: int,
                        halo_bytes_per_dev: int, num_devices: int,
                        edges_per_s_1dev: float,
                        local_edge_frac: Optional[float] = None,
                        ici_GBps: Optional[float] = None,
                        exchanges_per_step: int = 4) -> Dict:
        """Link-bandwidth cost model -> predicted scaling efficiency.

        Per rank and step the compute splits into the local part (which
        overlaps the exchange) and the remote part: ``T_step =
        max(T_local, T_comm) + T_remote``, efficiency ``(T_1dev / P) /
        T_step``, at ``ici_GBps`` (the all-to-all throughput per rank in
        GB/s, which the caller measures or states: there is no default)
        and at half and double it."""
        if ici_GBps is None:
            raise ValueError("predict_scaling needs the link bandwidth: "
                             "pass ici_GBps (GB/s per rank)")
        e_dev = num_edges / num_devices
        t_1dev = num_edges / edges_per_s_1dev
        lf = 0.8 if local_edge_frac is None else local_edge_frac
        out = {"assumed_ici_GBps": ici_GBps,
               "exchanges_per_step": exchanges_per_step}
        for label, bw in (("eff_half_bw", ici_GBps / 2),
                          ("eff", ici_GBps),
                          ("eff_double_bw", ici_GBps * 2)):
            t_comm = (halo_bytes_per_dev * exchanges_per_step
                      / (bw * 1e9))
            t_local = (e_dev * lf) / edges_per_s_1dev
            t_remote = (e_dev * (1 - lf)) / edges_per_s_1dev
            t_step = max(t_local, t_comm) + t_remote
            out[label] = round((t_1dev / num_devices) / t_step, 4)
        return out

    # ---- sharding helpers -------------------------------------------------

    def shard_nodes(self, x):
        """(N, ...) -> the (P, S, ...) stack on the partition's device."""
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        return torch.from_numpy(self.shards.shard_nodes(x)).to(self.device)

    def unshard_nodes(self, x):
        """The (P, S, ...) stack -> (N, ...) in the original order, numpy."""
        return self.shards.unshard_nodes(x, self.num_nodes)

    def stacked_consts(self):
        """``{rank: that rank's tables and operators}`` of the served
        ranks."""
        return self._consts

    def make_ctx(self, consts_slices) -> ShardCtx:
        """The rank's ctx from its tables (``stacked_consts()[rank]``)."""
        return ShardCtx(group=self.group, num_peers=self.num_devices,
                        halo_size=self.shards.halo_size,
                        nodes_per_shard=self.shards.nodes_per_shard,
                        ops=self.ops, consts=consts_slices)

    def _rank(self):
        if self.rank is None:
            raise RuntimeError("this process serves no single rank of the "
                               "partition")
        return self.rank

    # ---- whole-train-step plumbing ---------------------------------------

    def make_train_step(self, model, tx, loss_fn: Callable,
                        has_rng: bool = False):
        """``step(params, opt_state, x_sh, y_sh, mask_sh, key) -> (params,
        opt_state, loss)``: ``params`` the model (replicated), ``opt_state``
        its torch optimizer, the node stacks (P, S, ...), ``key`` the
        dropout generator when ``has_rng``. ``tx`` is a torch optimizer
        over the model's parameters or a factory of one; the optimizer is
        ``step.optimizer``, the ``opt_state`` to pass.

        ``loss_fn(logits_local, y_local, mask_local) -> (sum, count)`` is
        the UNREDUCED local numerator and denominator. The rank
        differentiates ``num / sum_ranks(count)`` (the sum detached), then
        the gradients and the loss are summed over the ranks in rank
        order: a masked mean exact across shards."""
        rank = self._rank()
        ctx = self.make_ctx(self._consts[rank])
        group = self.group
        opt = tx if isinstance(tx, torch.optim.Optimizer) \
            else tx(list(model.parameters()))

        def step(params, opt_state, x_sh, y_sh, mask_sh, key):
            ps = list(params.parameters())
            for p in ps:
                p.grad = None
            kwargs = {"train": True, "generator": key} if has_rng else {}
            logits = params(ctx, x_sh[rank], **kwargs)
            num, den = loss_fn(logits, y_sh[rank], mask_sh[rank])
            total_den = ordered_sum(den.detach().float().reshape(1),
                                    group).clamp_min(1.0)[0]
            local = num / total_den
            local.backward()
            flat = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in ps] + [local.detach().reshape(1)])
            total = ordered_sum(flat, group)
            at = 0
            for p in ps:
                p.grad = total[at:at + p.numel()].reshape(p.shape)
                at += p.numel()
            opt_state.step()
            return params, opt_state, total[at]

        step.optimizer = opt
        return step

    def init_model(self, model, x_sh, key=None, has_rng: bool = False):
        """The model on the partition's device with the parameters every
        rank shares. ``key`` (a ``torch.Generator``) redraws them as the
        model's constructor draws them from its ``generator``; then they
        are broadcast from the group's first rank. ``x_sh`` and
        ``has_rng`` are the JAX signature's (flax traces the model to make
        its parameters, a torch module has them already)."""
        from pytorch_geometric_tpu_torch.parallel.models import (
            reset_parameters)

        model = model.to(self.device)
        if key is not None:
            reset_parameters(model, key)
        if self.group is not None:
            src = dist.get_global_rank(self.group, 0)
            with torch.no_grad():
                for p in model.parameters():
                    dist.broadcast(p.data, src=src, group=self.group)
        return model

    def apply_model(self, model, params, x_sh, train: bool = False,
                    key=None):
        """The forward of every rank, gathered: a (P, S, C) stack on each
        rank, which :meth:`unshard_nodes` takes. ``params`` holds the
        weights (the model itself, or a state dict loaded into
        ``model``); ``key`` the dropout generator when ``train``."""
        rank = self._rank()
        if params is not None and params is not model:
            model.load_state_dict(params)
        kwargs = {"train": True, "generator": key} if train else {}
        with torch.no_grad():
            out = model(self.make_ctx(self._consts[rank]), x_sh[rank],
                        **kwargs)
        return all_gather_rows(out, self.group)
