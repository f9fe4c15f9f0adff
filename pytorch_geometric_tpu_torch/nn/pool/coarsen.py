"""Cluster-based coarsening pools: the graclus / voxel_grid pipelines.

Counterpart of ``pytorch_geometric_tpu/nn/pool/coarsen.py`` (reference:
``torch_geometric.nn.graclus`` + ``max_pool`` / ``max_pool_x`` /
``avg_pool``; examples/mnist_graclus.py:38-46,
examples/mnist_voxel_grid.py:30-39). Two paths, as in the JAX package:

- the host path (``max_pool`` / ``avg_pool`` on a numpy ``Data``): the
  reference's semantics, clusters relabelled consecutively, x reduced,
  pos averaged, edges coalesced; run at loader time to precompute each
  sample's coarsening levels. numpy, the JAX code's;
- the device path (``max_pool_x`` / ``pool_graph_masked``): static
  shapes, cluster ids in [0, N), the pooled tensors keep N rows with a
  validity mask. The maxima are torch's ``scatter_reduce``. The sums and
  means go through a ``SortedSegmentSum`` over the cluster ids
  (:func:`cluster_operator`, built on the host at loader time, where the
  ids are known, over the real nodes only) and the segment-sum kernel on
  a card; without it, on the CPU only, plain segment ops, and on a CUDA
  tensor they raise.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.cluster import (
    coalesce_edges, graclus_cluster)
from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.message_passing import require_cpu
from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.segment import (
    segment_max, segment_mean, segment_sum)
from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum


def graclus(senders, receivers, weight=None, num_nodes=None, seed=0):
    """Reference-API alias (examples/mnist_graclus.py:39)."""
    return graclus_cluster(senders, receivers, weight, num_nodes, seed)


# --- host path -------------------------------------------------------------

def _consecutive(cluster):
    uniq, inv = np.unique(np.asarray(cluster), return_inverse=True)
    return inv.astype(np.int64), uniq.shape[0]


def _pool_data(cluster, data: Data, reduce: str,
               transform: Optional[Callable] = None) -> Data:
    cl, k = _consecutive(cluster)
    out = Data()
    if data.x is not None:
        acc = np.full((k,) + data.x.shape[1:],
                      -np.inf if reduce == "max" else 0.0, dtype=np.float64)
        if reduce == "max":
            np.maximum.at(acc, cl, data.x)
        else:
            np.add.at(acc, cl, data.x)
            cnt = np.bincount(cl, minlength=k).astype(np.float64)
            acc = acc / np.maximum(cnt, 1.0)[
                (slice(None),) + (None,) * (data.x.ndim - 1)]
        out.x = acc.astype(np.float32)
    if data.pos is not None:
        acc = np.zeros((k,) + data.pos.shape[1:], dtype=np.float64)
        np.add.at(acc, cl, data.pos)
        cnt = np.bincount(cl, minlength=k).astype(np.float64)
        out.pos = (acc / np.maximum(cnt, 1.0)[:, None]).astype(np.float32)
    if data.edge_index is not None:
        s = cl[data.edge_index[0]]
        r = cl[data.edge_index[1]]
        keep = s != r
        ea = data.edge_attr[keep] if data.edge_attr is not None else None
        s2, r2, ea2 = coalesce_edges(s[keep], r[keep], ea, num_nodes=k)
        out.edge_index = np.stack([s2, r2])
        out.edge_attr = ea2
    if getattr(data, "batch", None) is not None:
        b = np.zeros(k, dtype=np.int64)
        b[cl] = np.asarray(data.batch)
        out.batch = b
    if data.y is not None:
        out.y = data.y
    if transform is not None:
        out = transform(out)
    return out


def max_pool(cluster, data: Data, transform=None) -> Data:
    """Host coarsening: scatter-max x, mean pos, coalesced edges
    (reference max_pool, examples/mnist_graclus.py:41)."""
    return _pool_data(cluster, data, "max", transform)


def avg_pool(cluster, data: Data, transform=None) -> Data:
    return _pool_data(cluster, data, "mean", transform)


# --- device path -----------------------------------------------------------

def _routed(cluster, graph: Graph):
    """The cluster ids with the nodes outside the mask routed to the last
    row, N - 1, as ``pool_graph_masked`` routes them."""
    n = graph.num_nodes
    nm = graph.real_node_mask()
    return torch.where(nm, torch.as_tensor(cluster, device=nm.device).long(),
                       n - 1)


def cluster_operator(cluster, graph: Graph, device=None
                     ) -> SortedSegmentSum:
    """The ``SortedSegmentSum`` of :func:`pool_graph_masked` over
    ``cluster`` (N ids of ``graph``'s nodes, the nodes outside its mask
    routed to N - 1) into N rows, on ``device`` (default: the graph's).
    Built on the host.

    Its CSR holds the real nodes only (``entry_mask``): the nodes outside
    the mask hand 0 to every sum of the pool, and 1 to the count of the
    means, whose row N - 1 then reads 0 / count = 0 either way. Where a
    real cluster is N - 1 (a graph with no padding node), that row is
    read, and the JAX mean counts the nodes routed there: every node
    keeps its entry, as in the padded operator."""
    ids = host_array(_routed(cluster, graph))
    real = host_array(graph.real_node_mask())
    n = graph.num_nodes
    keep = None if (ids[real] == n - 1).any() else real
    return SortedSegmentSum(ids, n, entry_mask=keep,
                            device=graph.device if device is None
                            else device)


def max_pool_x(cluster, x, batch, num_clusters: Optional[int] = None,
               node_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device segment-max of x by cluster id (reference max_pool_x,
    examples/mnist_graclus.py:46). Static output rows = num_clusters
    (default: x rows). Returns (pooled_x, pooled_batch)."""
    n = num_clusters if num_clusters is not None else x.shape[0]
    cluster = torch.as_tensor(cluster, device=x.device)
    if node_mask is not None:
        big = torch.finfo(x.dtype).min
        x = torch.where(node_mask[:, None], x, big)
    out = segment_max(x, cluster, n)
    pooled_batch = segment_max(batch, cluster, n)
    return out, pooled_batch


def _cluster_mean(v, cl, n, segment_op):
    """``segment_mean(v, cl, n)`` through ``segment_op``: the rows and
    their count summed in one call."""
    sums = segment_op(torch.cat([v, v.new_ones((v.shape[0], 1))], 1))
    return sums[:, :-1] / sums[:, -1:].clamp_min(1.0)


def pool_graph_masked(cluster, graph: Graph, reduce: str = "max",
                      segment_op: Optional[SortedSegmentSum] = None
                      ) -> Graph:
    """In-step coarsening with static shapes: the pooled graph keeps N
    rows; rows that no cluster uses are masked out, edges are relabelled
    to cluster ids with the self loops they collapse to masked off.
    ``segment_op``: :func:`cluster_operator` of ``cluster`` and
    ``graph``, for the sums and means."""
    N = graph.num_nodes
    nm = graph.real_node_mask()
    cl = _routed(cluster, graph)
    occupied = segment_max(nm.to(torch.int32), cl, N) > 0
    needs_sums = (graph.x is not None and reduce in ("mean", "add")) or \
        graph.pos is not None
    ref = graph.x if graph.x is not None else graph.pos
    if needs_sums and segment_op is None:
        require_cpu(ref, f"pool_graph_masked(reduce={reduce!r})",
                    "segment_op (cluster_operator)")

    def mean(v):
        if segment_op is None:
            return segment_mean(v, cl, N)
        return _cluster_mean(v, cl, N, segment_op)

    x = None
    if graph.x is not None:
        xin = torch.where(nm[:, None], graph.x, 0.0)
        if reduce == "max":
            x = segment_max(xin, cl, N)
        elif reduce == "mean":
            x = mean(xin)
        else:
            x = segment_op(xin) if segment_op is not None else \
                segment_sum(xin, cl, N)
    pos = None
    if graph.pos is not None:
        pos = mean(torch.where(nm[:, None], graph.pos, 0.0))
    batch = None
    if graph.batch is not None:
        batch = segment_max(graph.batch, cl, N)
    s = cl[graph.senders.long()].to(graph.senders.dtype)
    r = cl[graph.receivers.long()].to(graph.receivers.dtype)
    ekeep = graph.real_edge_mask() & (s != r)
    return graph.replace(
        senders=s, receivers=r, x=x, pos=pos, batch=batch,
        node_mask=occupied, edge_mask=ekeep, edges_sorted=False)
