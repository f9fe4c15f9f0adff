"""Block-diagonal collation with static-shape padding.

Counterpart of ``pytorch_geometric_tpu/data/batch.py`` (``bucket_size``,
``collate``, ``from_data``), with the same conventions:

- node/edge budgets follow the 1.5x geometric ladder (Cora: 2708 nodes
  -> N=3072, 10556 edges -> E=12288);
- padding nodes are appended after real nodes (masked out via
  ``node_mask``); all padding edges point at node ``tot_n``, the first
  padding node, with ``edge_mask`` False;
- padding nodes belong to a dedicated padding graph (the last graph id);
- edges are sorted by receiver, edge-level fields permuted with them.

Collation happens on the host in numpy; the result is moved to ``device``
once.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device


def bucket_size(n: int, minimum: int = 16) -> int:
    """Geometric bucket ladder: powers of two interleaved with 1.5x, so
    padding waste is <= 33% while distinct shapes grow logarithmically."""
    if n <= minimum:
        return minimum
    b = minimum
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def collate(
    data_list: Sequence[Data],
    num_nodes: Optional[int] = None,
    num_edges: Optional[int] = None,
    num_graphs: Optional[int] = None,
    follow_keys: Optional[List[str]] = None,
    sort_edges: bool = True,
    device="cuda",
) -> Graph:
    """Collate host ``Data`` records into one padded ``Graph`` on
    ``device``. ``follow_keys`` is accepted and unused, as in the JAX
    package."""
    dev = resolve_device(device)
    G = len(data_list)
    tot_n = sum(d.num_nodes for d in data_list)
    tot_e = sum(d.num_edges for d in data_list)
    # Budgets: always >= one padding node (edge padding target) and one
    # padding graph (padding nodes' segment).
    N = num_nodes if num_nodes is not None else bucket_size(tot_n + 1)
    E = num_edges if num_edges is not None else bucket_size(max(tot_e, 1))
    GB = num_graphs if num_graphs is not None else G + 1
    if N <= tot_n:
        raise ValueError(f"num_nodes budget {N} <= total real nodes {tot_n} "
                         "(need >= 1 padding node)")
    if E < tot_e:
        raise ValueError(f"num_edges budget {E} < total real edges {tot_e}")
    if GB <= G:
        raise ValueError(f"num_graphs budget {GB} <= {G} "
                         "(need >= 1 padding graph)")

    senders = np.full(E, tot_n, dtype=np.int32)   # pad edges -> pad node
    receivers = np.full(E, tot_n, dtype=np.int32)
    edge_mask = np.zeros(E, dtype=bool)
    node_mask = np.zeros(N, dtype=bool)
    node_mask[:tot_n] = True
    batch = np.full(N, GB - 1, dtype=np.int32)    # pad nodes -> pad graph

    node_off = 0
    edge_off = 0
    node_fields, edge_fields, graph_fields = {}, {}, {}
    for gid, d in enumerate(data_list):
        n, e = d.num_nodes, d.num_edges
        if d.edge_index is not None and e:
            senders[edge_off:edge_off + e] = d.edge_index[0] + node_off
            receivers[edge_off:edge_off + e] = d.edge_index[1] + node_off
            edge_mask[edge_off:edge_off + e] = True
        batch[node_off:node_off + n] = gid
        for key, value in d:
            if key in ("edge_index", "face"):
                continue
            # node-index-valued fields (host-precomputed cluster maps)
            # must be offset like edge_index
            if key.startswith("cluster"):
                value = value + node_off
            if key == "y":
                is_node = value.ndim > 0 and value.shape[:1] == (n,) \
                    and n != G
                (node_fields if is_node else graph_fields).setdefault(
                    key, []).append(value)
            elif d.is_edge_level(key, value):
                edge_fields.setdefault(key, []).append(value)
            elif d.is_node_level(key, value):
                node_fields.setdefault(key, []).append(value)
            else:
                graph_fields.setdefault(key, []).append(value)
        node_off += n
        edge_off += e

    def pad_cat(chunks, total, fill=0):
        cat = np.concatenate([np.atleast_1d(c) for c in chunks], axis=0)
        pad_rows = total - cat.shape[0]
        if pad_rows > 0:
            pad = np.full((pad_rows,) + cat.shape[1:], fill, dtype=cat.dtype)
            cat = np.concatenate([cat, pad], axis=0)
        return cat

    node_arrays = {k: pad_cat(v, N) for k, v in node_fields.items()}
    edge_arrays = {k: pad_cat(v, E) for k, v in edge_fields.items()}
    graph_arrays = {}
    for k, v in graph_fields.items():
        stacked = [np.atleast_1d(np.asarray(c)) for c in v]
        if all(c.shape == stacked[0].shape for c in stacked):
            arr = np.stack(stacked, axis=0) if stacked[0].ndim == 0 or \
                stacked[0].shape[0] != 1 else np.concatenate(stacked, axis=0)
        else:
            arr = np.concatenate(stacked, axis=0)
        pad_rows = GB - arr.shape[0]
        if pad_rows > 0:
            pad = np.zeros((pad_rows,) + arr.shape[1:], dtype=arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        graph_arrays[k] = arr

    if sort_edges:
        # one stable order whatever the algorithm; for keys below 2^16
        # numpy's stable sort of uint16 is a radix sort, ~5x faster at
        # PPI's 98,304 edge slots (the host's share of a captured step)
        keys = receivers.astype(np.uint16) if N <= 1 << 16 else receivers
        order = np.argsort(keys, kind="stable")
        senders, receivers = senders[order], receivers[order]
        edge_mask = edge_mask[order]
        edge_arrays = {k: v[order] for k, v in edge_arrays.items()}

    x = node_arrays.pop("x", None)
    pos = node_arrays.pop("pos", None)
    y = node_arrays.pop("y", None)
    if y is None:
        y = graph_arrays.pop("y", None)
    edge_attr = edge_arrays.pop("edge_attr", None)

    def to_dev(a):
        # the JAX package's dtype policy: 64-bit host arrays become 32-bit
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    extras = {k: to_dev(v) for k, v in
              {**node_arrays, **edge_arrays, **graph_arrays}.items()}
    extras["graph_mask"] = to_dev(np.arange(GB) < G)

    return Graph(
        senders=to_dev(senders), receivers=to_dev(receivers),
        x=to_dev(x), edge_attr=to_dev(edge_attr), pos=to_dev(pos),
        y=to_dev(y), node_mask=to_dev(node_mask),
        edge_mask=to_dev(edge_mask), batch=to_dev(batch), extras=extras,
        num_graphs=GB, edges_sorted=sort_edges,
    )


def from_data(data: Data, num_nodes=None, num_edges=None,
              sort_edges: bool = True, device="cuda") -> Graph:
    """Collate a single graph (transductive workloads: Cora et al.)."""
    return collate([data], num_nodes=num_nodes, num_edges=num_edges,
                   sort_edges=sort_edges, device=device)

