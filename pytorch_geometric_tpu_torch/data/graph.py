"""`Graph` — the padded, static-shape graph record of torch tensors.

Counterpart of ``pytorch_geometric_tpu/data/graph.py``, with the same
fields and padding conventions:

- N and E include padding; ``node_mask`` / ``edge_mask`` mark real
  entries. Padded edges point at a designated padding node (with
  ``edge_mask`` False), so segment ops stay correct without branching.
- Extra per-node/graph fields (train/val/test masks, ...) ride in the
  ``extras`` dict and are reachable as attributes (``graph.train_mask``).

Unlike the JAX pytree, a ``Graph`` here lives on one torch device and
moves with :meth:`Graph.to`.
"""

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly batched, possibly padded) graph of torch tensors."""

    senders: torch.Tensor                      # (E,) int32 — edge_index[0]
    receivers: torch.Tensor                    # (E,) int32 — edge_index[1]
    x: Optional[torch.Tensor] = None           # (N, F)
    edge_attr: Optional[torch.Tensor] = None   # (E, Fe)
    pos: Optional[torch.Tensor] = None         # (N, D)
    y: Optional[torch.Tensor] = None           # (N, ...) or (G, ...)
    node_mask: Optional[torch.Tensor] = None   # (N,) bool; None = all valid
    edge_mask: Optional[torch.Tensor] = None   # (E,) bool
    batch: Optional[torch.Tensor] = None       # (N,) int32 graph ids
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_graphs: int = 1
    # True when edges are sorted by receiver (set by the collation).
    edges_sorted: bool = False

    # --- shape helpers ----------------------------------------------------

    @property
    def num_nodes(self) -> int:
        """Padded node count N."""
        for t in (self.x, self.pos, self.node_mask, self.batch):
            if t is not None:
                return t.shape[0]
        return int(torch.maximum(self.senders, self.receivers).max()) + 1

    @property
    def num_edges(self) -> int:
        """Padded edge count E."""
        return self.senders.shape[0]

    @property
    def num_node_features(self) -> int:
        return 0 if self.x is None else self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def real_edge_mask(self) -> torch.Tensor:
        if self.edge_mask is not None:
            return self.edge_mask
        return torch.ones(self.num_edges, dtype=torch.bool,
                          device=self.device)

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Graph":
        """Copy every tensor (extras included) to ``device``."""
        def move(v):
            return v.to(device) if isinstance(v, torch.Tensor) else v

        fields = {f.name: move(getattr(self, f.name))
                  for f in dataclasses.fields(self) if f.name != "extras"}
        return Graph(**fields,
                     extras={k: move(v) for k, v in self.extras.items()})

    def __getattr__(self, key):
        # Open attribute namespace like the reference's Data: extras are
        # reachable as graph.train_mask etc.  (Only called when normal
        # attribute lookup fails.)
        extras = object.__getattribute__(self, "extras")
        if key in extras:
            return extras[key]
        raise AttributeError(key)
