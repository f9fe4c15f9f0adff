"""TopK pooling (Gao & Ji / Cangea et al.).

Counterpart of ``pytorch_geometric_tpu/nn/pool/topk_pool.py`` (reference:
``torch_geometric.nn.TopKPooling``; examples/enzymes_topk_pool.py:25-47,
ratio 0.8 stacks): score = x . p / ||p||; keep the top ceil(ratio * n_i)
nodes of each graph; gate the kept rows with tanh(score); drop the edges
that touch a dropped node.

Shapes stay static, as in the JAX package: the pooled graph is the same
``Graph`` with a new ``node_mask`` and ``edge_mask`` and gated features,
so its senders and receivers do not change and the batch's operators
(``propagate_operators``) serve every level, the new ``edge_mask`` going
in as the edge weight. A node's rank in its graph is its position after a
stable sort by (graph, -score): two ``torch.sort(stable=True)`` passes,
the JAX ``lexsort``, so tied scores (rows of zeros after a ReLU) keep
the lower node first.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.nn.inits import uniform


def topk_mask(score, graph: Graph, ratio: float):
    """Boolean mask of each graph's top ceil(ratio * n) scores among its
    real nodes (padding nodes never kept)."""
    N = graph.num_nodes
    batch = graph.batch if graph.batch is not None else \
        torch.zeros((N,), dtype=torch.int32, device=score.device)
    nm = graph.real_node_mask()
    G = graph.num_graphs
    # rank within graph: sort by (batch, -score); padded nodes last
    key_batch = torch.where(nm, batch.long(), G)
    by_score = torch.sort(-score, stable=True).indices
    order = by_score[torch.sort(key_batch[by_score], stable=True).indices]
    sorted_batch = key_batch[order]
    start = torch.searchsorted(sorted_batch, torch.arange(
        G + 1, device=score.device))
    pos_in_sorted = torch.arange(N, device=score.device) - start[sorted_batch]
    rank = torch.empty_like(pos_in_sorted).scatter_(0, order, pos_in_sorted)
    # per-graph budget: the real nodes of graph g are the run of key g
    counts = (start[1:] - start[:-1]).to(torch.float32)
    k = torch.ceil(ratio * counts).to(torch.int64)
    return nm & (rank < k[batch.long()])


class TopKPooling(nn.Module):
    """``weight`` (in_channels,): the projection p."""

    def __init__(self, in_channels: int, ratio: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.ratio = ratio
        self.weight = nn.Parameter(uniform(in_channels)((in_channels,),
                                                        generator))

    def forward(self, graph: Graph, x, edge_attr=None
                ) -> Tuple[Graph, torch.Tensor, torch.Tensor]:
        """``(pooled_graph, gated_x, score)``: the reference's (x,
        edge_index, edge_attr, batch, perm, score) as a masked graph."""
        p = self.weight
        score = (x @ p) / torch.linalg.norm(p).clamp_min(1e-12)
        keep = topk_mask(score, graph, self.ratio)
        gated = x * torch.tanh(score)[:, None]
        gated = torch.where(keep[:, None], gated, 0.0)
        ekeep = keep[graph.senders.long()] & keep[graph.receivers.long()] \
            & graph.real_edge_mask()
        new_graph = graph.replace(
            node_mask=keep, edge_mask=ekeep, x=gated,
            edge_attr=edge_attr if edge_attr is not None
            else graph.edge_attr)
        return new_graph, gated, score

