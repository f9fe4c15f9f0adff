"""Neighbor-sampled mini-batch loader (GraphSAGE-style).

Counterpart of ``pytorch_geometric_tpu/data/neighbor_loader.py``, the
sampled mini-batch configuration "GraphSAGE + NeighborSampler on
PPI/Reddit" (examples/reddit_sage.py):

- a host CSR of in-edges, built once; per batch, multi-hop uniform
  sampling from the seed nodes through the port's native
  ``cluster.sample_neighbors`` (the JAX library's draws, bitwise);
- the sampled nodes compacted to local ids, seeds first, and padded to
  static budgets (one shape per loader); padding edges and the ids of
  padding nodes point at the sentinel ``num_nodes``; edges sorted by
  receiver; ``seed_mask`` marks the rows the loss reads;
- ``materialize_features=False`` ships indices only: the consumer keeps
  the feature and label tables on the card (:meth:`device_tables`, a
  zero row appended for the sentinel) and gathers a batch's rows through
  ``extras["local_to_global"]``;
- :meth:`iter_packed` / :meth:`unpack`: one int32 buffer a batch, one
  host-to-device copy, the ``Graph`` rebuilt from views of it (the leaf
  order is the port's own: :data:`PACKED_LEAVES`);
- ``prefetch > 0``: a producer thread samples ahead (numpy work only)
  into a bounded queue, and the consumer copies each batch to the card;
  the producer stops when the consumer abandons the epoch;
- :meth:`iter_host`: host batches, each with what a ``build`` function
  makes of it on the host beside it (examples/reddit_sage.py: the
  batch's neighbour-sum operator), in the producer thread when
  ``prefetch > 0``; the consumer copies both in (a captured step's
  static buffers, on the current stream), and the producer never touches
  the card.

Everything up to the copy is host numpy, the JAX function's, so a seed
gives both packages the same batches.
"""

import queue
import threading
from typing import Sequence

import numpy as np
import torch

from pytorch_geometric_tpu_torch.cluster import sample_neighbors
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device

#: The leaves of a packed batch, in buffer order: ``(name, row budget)``
#: with ``"E"`` the edge budget and ``"N"`` the node budget; masks travel
#: as 0 / 1.
PACKED_LEAVES = (("senders", "E"), ("receivers", "E"), ("edge_mask", "E"),
                 ("node_mask", "N"), ("seed_mask", "N"),
                 ("local_to_global", "N"))
_INDEX_ONLY = ("packed batches require the index-shipping mode "
               "(materialize_features=False): all leaves are integral")


class NeighborSampler:
    """Iterates padded sampled subgraphs over seed-node batches, on
    ``device`` (the card by default)."""

    def __init__(self, senders, receivers, num_nodes: int,
                 sizes: Sequence[int], node_features=None, labels=None,
                 batch_size: int = 512, shuffle: bool = True,
                 seed_nodes=None, seed: int = 0,
                 materialize_features: bool = True,
                 prefetch: int = 0, device="cuda"):
        """``materialize_features=False`` ships indices only (no ``x`` /
        ``y`` in the batches). ``prefetch > 0`` samples that many batches
        ahead in a producer thread."""
        senders = np.asarray(senders, dtype=np.int64)
        receivers = np.asarray(receivers, dtype=np.int64)
        self.num_nodes = int(num_nodes)
        self.sizes = list(sizes)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.materialize_features = bool(materialize_features)
        self.x = None if node_features is None else \
            np.asarray(node_features)
        self.y = None if labels is None else np.asarray(labels)
        self.seed_nodes = np.arange(num_nodes) if seed_nodes is None \
            else np.asarray(seed_nodes)
        self.prefetch = int(prefetch)
        self.device = resolve_device(device)

        # CSR over receivers (in-neighbours per node)
        order = np.argsort(receivers, kind="stable")
        self._indices = senders[order]
        counts = np.bincount(receivers, minlength=num_nodes)
        self._indptr = np.concatenate([[0], np.cumsum(counts)])

        # static budgets
        frontier = batch_size
        n_budget = batch_size
        e_budget = 0
        for s in self.sizes:
            e_budget += frontier * s
            frontier = frontier * s
            n_budget += frontier
        self.node_budget = n_budget + 1      # +1 padding node
        self.edge_budget = max(e_budget, 1)

    def __len__(self):
        return -(-len(self.seed_nodes) // self.batch_size)

    def _batches(self):
        seeds = self.seed_nodes.copy()
        if self.shuffle:
            self._rng.shuffle(seeds)
        return [seeds[s: s + self.batch_size]
                for s in range(0, len(seeds), self.batch_size)]

    # ---- packed single-buffer batches --------------------------------

    def pack_batch(self, g_np: Graph) -> np.ndarray:
        """Flatten a host batch (index mode) into one int32 buffer, in
        :data:`PACKED_LEAVES` order."""
        if self.materialize_features:
            raise ValueError(_INDEX_ONLY)
        return np.concatenate(
            [np.asarray(_leaf(g_np, name)).astype(np.int32).reshape(-1)
             for name, _ in PACKED_LEAVES])

    def unpack(self, buf) -> Graph:
        """The batch ``Graph`` of a packed buffer (a tensor on any
        device): the index leaves are views of ``buf``, the masks bool."""
        sizes = {"E": self.edge_budget, "N": self.node_budget}
        out, off = {}, 0
        for name, budget in PACKED_LEAVES:
            n = sizes[budget]
            out[name] = buf[off: off + n]
            off += n
        if off != buf.shape[0]:
            raise ValueError(f"a packed batch holds {off} int32 values, "
                             f"got {buf.shape[0]}")
        return Graph(senders=out["senders"], receivers=out["receivers"],
                     node_mask=out["node_mask"] != 0,
                     edge_mask=out["edge_mask"] != 0,
                     extras={"seed_mask": out["seed_mask"] != 0,
                             "local_to_global": out["local_to_global"]},
                     num_graphs=1, edges_sorted=True)

    def iter_packed(self):
        """Like ``__iter__`` but yields packed buffers on ``device`` (one
        host-to-device copy a batch); honours ``prefetch``."""
        if self.materialize_features:
            raise ValueError(_INDEX_ONLY)
        for buf in self._produce(self._batches(),
                                 lambda b: self.pack_batch(self._sample(b))):
            yield torch.from_numpy(buf).to(self.device)

    def __iter__(self):
        for g in self._produce(self._batches(), self._sample):
            yield g.to(self.device)

    def iter_host(self, build):
        """``(batch, build(batch))`` a seed batch, both on the host: the
        batch as ``__iter__``'s before its copy, and ``build``'s host work
        on it done beside the sampling (in the producer thread when
        ``prefetch > 0``). Nothing is copied to ``device``; honours
        ``prefetch``."""
        def make(b):
            g = self._sample(b)
            return g, build(g)

        return self._produce(self._batches(), make)

    def _produce(self, batches, make):
        """``make(b)`` of every seed batch, in order: inline, or with
        ``prefetch > 0`` from a producer thread through a bounded queue.
        The producer is the only caller of ``self._rng`` while it runs
        (the consumer shuffled before it started, and joins it before
        going on); it does host work only, the consumer copies to the
        card; it stops after its current batch when the consumer abandons
        the epoch, whatever it was putting (a batch, the end or an
        exception), and its exceptions surface in the consumer."""
        if self.prefetch <= 0:
            for b in batches:
                yield make(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped; False then."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in batches:
                    if not put(make(b)):
                        return
                put(done)
            except BaseException as exc:   # surface in the consumer
                put(exc)

        t = threading.Thread(target=produce, daemon=True,
                             name="neighbor-sampler-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def _sample(self, seeds: np.ndarray) -> Graph:
        """One batch on the host (CPU tensors over numpy arrays)."""
        all_src, all_dst = [], []
        frontier = seeds
        for k in self.sizes:
            src, dst = sample_neighbors(
                self._indptr, self._indices, frontier, k,
                seed=int(self._rng.integers(2 ** 31)))
            all_src.append(src)
            all_dst.append(dst)
            frontier = np.unique(src)
        src = np.concatenate(all_src) if all_src else \
            np.empty(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else \
            np.empty(0, np.int64)

        # compact: seeds first (so seed rows are 0..B-1), then the rest
        nodes = np.concatenate([seeds, src, dst])
        uniq = np.unique(nodes)
        rest = np.setdiff1d(uniq, seeds, assume_unique=False)
        local_ids = np.concatenate([seeds, rest])
        lorder = np.argsort(local_ids, kind="stable")
        sorted_ids = local_ids[lorder]
        n_real = len(local_ids)
        e_real = len(src)

        N, E = self.node_budget, self.edge_budget
        # the budgets follow from the per-hop fan-out caps, so overflow
        # means the sampler broke its invariant: fail loud
        if n_real + 1 > N or e_real > E:
            raise RuntimeError(
                f"sampled subgraph exceeds static budget "
                f"({n_real + 1}>{N} nodes or {e_real}>{E} edges) — "
                "sampler invariant violated")

        s_local = np.full(E, n_real, np.int32)
        d_local = np.full(E, n_real, np.int32)
        s_local[:e_real] = lorder[np.searchsorted(sorted_ids, src)]
        d_local[:e_real] = lorder[np.searchsorted(sorted_ids, dst)]
        edge_mask = np.zeros(E, bool)
        edge_mask[:e_real] = True
        node_mask = np.zeros(N, bool)
        node_mask[:n_real] = True
        seed_mask = np.zeros(N, bool)
        seed_mask[: len(seeds)] = True

        x = None
        if self.x is not None and self.materialize_features:
            x = np.zeros((N,) + self.x.shape[1:], np.float32)
            x[:n_real] = self.x[local_ids]
        y = None
        if self.y is not None and self.materialize_features:
            y = np.zeros((N,) + self.y.shape[1:], self.y.dtype)
            y[:n_real] = self.y[local_ids]

        # sort by receiver
        order = np.argsort(d_local, kind="stable")
        t = torch.from_numpy
        return Graph(
            senders=t(s_local[order]), receivers=t(d_local[order]),
            x=None if x is None else t(x), y=None if y is None else t(y),
            node_mask=t(node_mask), edge_mask=t(edge_mask[order]),
            extras={"seed_mask": t(seed_mask),
                    # padding rows point at the sentinel id num_nodes:
                    # gathers through device_tables() read its zero row
                    "local_to_global": t(np.concatenate(
                        [local_ids, np.full(N - n_real, self.num_nodes,
                                            np.int64)]).astype(np.int32))},
            num_graphs=1, edges_sorted=True)

    def device_tables(self, *arrays):
        """Each (num_nodes, ...) table on ``device`` with one zero row
        appended, so that the sentinel id ``num_nodes`` gathers zeros.
        Keep them there and gather a batch's rows through
        ``extras["local_to_global"]`` (the index-shipping path)."""
        out = []
        for a in arrays:
            a = np.asarray(a)
            out.append(torch.from_numpy(np.concatenate(
                [a, np.zeros((1,) + a.shape[1:], a.dtype)])).to(self.device))
        return out[0] if len(out) == 1 else tuple(out)


def _leaf(g: Graph, name: str):
    return g.extras[name] if name in g.extras else getattr(g, name)
