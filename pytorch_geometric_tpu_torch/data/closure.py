"""Layered training closure: exact dead-computation elimination.

Counterpart of ``pytorch_geometric_tpu/data/closure.py``. Where the loss
reads a small set of labelled nodes (examples/rgcn.py: 272 train
entities of 23,644), a full-graph forward computes almost every edge for
nothing: the gradients of values that never reach the loss are exactly
zero. This module extracts, per layer, the edges and nodes whose values
can reach the seed nodes (the L-layer receptive field) and relabels them
into compact padded bipartite layers. Training on them follows the
full-graph parameter trajectory, while the per-edge work drops by the
closure's ratio (MUTAG-RDF's 2-layer RGCN: 142k -> 13.3k + 2.0k edges).

The extraction is the JAX package's host numpy, line for line (so every
field is bitwise the same); the layers' index arrays then land on
``device`` as int32 (``edge_mask`` bool) tensors. ``n_in``, ``n_out`` and
the counts of real edges and nodes stay Python ints. The convs' closure
paths (``GCNConv``, ``GATConv``, ``RGCNConv``) take one layer each.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pytorch_geometric_tpu_torch.device import resolve_device


def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    return np.concatenate([x, np.full(pad, fill, dtype=x.dtype)])


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


class ClosureLayer(NamedTuple):
    """One bipartite layer of the closure (static padded shapes).

    Maps features on ``n_in`` input nodes to ``n_out`` output nodes.
    Output nodes are a prefix of the input nodes: ``self_idx[i]`` (= i)
    is the position of output node i among the inputs. Padding edges run
    from input ``n_in - 1`` to output ``n_out - 1`` with ``edge_mask``
    False.
    """
    senders: torch.Tensor        # (Ep,) local index into input nodes
    sender_global: torch.Tensor  # (Ep,) global node id of each sender
    receivers: torch.Tensor      # (Ep,) local index into output nodes
    edge_type: torch.Tensor      # (Ep,) int32 (zeros if untyped)
    edge_mask: torch.Tensor      # (Ep,) bool, True = real edge
    in_global: torch.Tensor      # (n_in,) global node id per input node
    out_global: torch.Tensor     # (n_out,) global node id per output
    self_idx: torch.Tensor       # (n_out,) position of output in input
    n_in: int
    n_out: int
    num_real_edges: int
    num_real_in: int
    num_real_out: int


def layered_training_closure(
        edge_index, seeds, num_layers: int,
        num_nodes: Optional[int] = None, edge_type=None,
        pad_multiple: int = 128, device="cuda") -> List[ClosureLayer]:
    """Per-layer exact receptive field of ``seeds``, deepest first.

    Returns ``num_layers`` ClosureLayers ordered for forward execution
    (layer 0 consumes raw / global features, the last layer produces the
    seed outputs), their tensors on ``device``. ``out_global`` of the
    final layer lists the seeds in their original order. ``edge_index``
    and ``edge_type`` are host arrays (or tensors, copied to the host).
    """
    dev = resolve_device(device)
    ei = _host(edge_index)
    et = (_host(edge_type).astype(np.int64)
          if edge_type is not None else np.zeros(ei.shape[1], np.int64))
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1
    seeds = np.atleast_1d(_host(seeds)).astype(np.int64)

    # walk backwards: nodes needed at each layer's output
    out_sets = [seeds]
    edge_sets = []
    need = np.zeros(num_nodes, dtype=bool)
    cur = seeds
    for _ in range(num_layers):
        need[:] = False
        need[cur] = True
        emask = need[ei[1]]
        edge_sets.append(emask)
        senders = np.unique(ei[0][emask])
        extra = senders[~np.isin(senders, cur, assume_unique=False)]
        # output nodes first so self_idx is a prefix map
        cur = np.concatenate([cur, np.setdiff1d(extra, cur)])
        out_sets.append(cur)
    # out_sets[l] = nodes needed at INPUT of layer (num_layers - l)
    out_sets.reverse()
    edge_sets.reverse()

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    layers = []
    for li in range(num_layers):
        in_nodes = out_sets[li]
        out_nodes = out_sets[li + 1]
        emask = edge_sets[li]
        s, r, t = ei[0][emask], ei[1][emask], et[emask]

        remap_in = np.full(num_nodes, -1, dtype=np.int64)
        remap_in[in_nodes] = np.arange(in_nodes.shape[0])
        remap_out = np.full(num_nodes, -1, dtype=np.int64)
        remap_out[out_nodes] = np.arange(out_nodes.shape[0])

        n_in = _round_up(in_nodes.shape[0] + 1, pad_multiple)
        n_out = _round_up(out_nodes.shape[0] + 1, pad_multiple)
        ep = _round_up(s.shape[0], pad_multiple)

        sl = _pad_to(remap_in[s], ep, fill=n_in - 1).astype(np.int32)
        rl = _pad_to(remap_out[r], ep, fill=n_out - 1).astype(np.int32)
        tl = _pad_to(t, ep, fill=0).astype(np.int32)
        mask = np.zeros(ep, dtype=bool)
        mask[: s.shape[0]] = True

        in_g = _pad_to(in_nodes, n_in, fill=0).astype(np.int32)
        out_g = _pad_to(out_nodes, n_out, fill=0).astype(np.int32)
        # out_nodes is a prefix of in_nodes by construction
        self_idx = np.arange(n_out, dtype=np.int32)
        self_idx = np.minimum(self_idx, n_in - 1)

        sg = _pad_to(s, ep, fill=0).astype(np.int32)

        layers.append(ClosureLayer(
            senders=on_dev(sl), sender_global=on_dev(sg),
            receivers=on_dev(rl), edge_type=on_dev(tl),
            edge_mask=on_dev(mask), in_global=on_dev(in_g),
            out_global=on_dev(out_g), self_idx=on_dev(self_idx),
            n_in=n_in, n_out=n_out, num_real_edges=int(s.shape[0]),
            num_real_in=int(in_nodes.shape[0]),
            num_real_out=int(out_nodes.shape[0])))
    return layers


def real_edges(cl: ClosureLayer):
    """``(senders, sender_global, receivers, edge_type)`` of the layer's
    real edges as host int64 arrays: the padding edges are its tail."""
    e = cl.num_real_edges
    return tuple(t[:e].cpu().numpy().astype(np.int64) for t in
                 (cl.senders, cl.sender_global, cl.receivers, cl.edge_type))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)
