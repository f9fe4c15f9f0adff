"""Loaders: host-side batching that feeds padded ``Graph`` batches to a
device.

Counterpart of ``pytorch_geometric_tpu/data/loader.py``:

- ``DataLoader``      — block-diagonal collation + ``batch`` vector
                        (examples/mutag_gin.py:14-15, examples/ppi.py);
- ``DataListLoader``  — Python lists of graphs, the input of data
                        parallelism (examples/data_parallel.py:6,12);
- ``DenseDataLoader`` — stacks equal-size dense fields for DiffPool
                        (examples/enzymes_diff_pool.py:8,32-34).

Every batch is padded to the loader's budgets (``data/batch.py``'s
``bucket_size`` ladder): by default one static budget for the loader,
from its ``batch_size`` largest graphs, so every batch has one shape; with
``dynamic_buckets`` each batch pads to its own rung, capped by that
budget. The order is ``np.random.default_rng(seed).shuffle`` of the
indices once per epoch, as in the JAX loaders, so one seed gives both
packages the same batches in the same order. Batches are collated on the
host in numpy and land on ``device`` (the card by default).
"""

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from pytorch_geometric_tpu_torch.data.batch import bucket_size, collate
from pytorch_geometric_tpu_torch.data.data import Data
from pytorch_geometric_tpu_torch.data.graph import Graph
from pytorch_geometric_tpu_torch.device import resolve_device


class _Batches:
    """Shared order and chunking of the three loaders."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _chunks(self) -> Iterator[np.ndarray]:
        """The dataset indices of each batch of one epoch."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        for start in range(0, len(idx), bs):
            chunk = idx[start:start + bs]
            if self.drop_last and len(chunk) < bs:
                break
            yield chunk


class DataLoader(_Batches):
    """Iterate padded, collated ``Graph`` batches over a dataset."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_nodes: Optional[int] = None,
                 num_edges: Optional[int] = None,
                 dynamic_buckets: bool = False, device="cuda"):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)
        self.dynamic_buckets = dynamic_buckets
        self.device = resolve_device(device)
        if num_nodes is None or num_edges is None:
            # the worst batch: the batch_size largest graphs
            sizes_n = sorted((d.num_nodes for d in dataset), reverse=True)
            sizes_e = sorted((d.num_edges for d in dataset), reverse=True)
            worst_n = sum(sizes_n[:batch_size]) + 1
            worst_e = max(sum(sizes_e[:batch_size]), 1)
            num_nodes = num_nodes or bucket_size(worst_n)
            num_edges = num_edges or bucket_size(worst_e)
        self.num_nodes = num_nodes
        self.num_edges = num_edges
        self.num_graphs = batch_size + 1

    def indexed(self, device=None) -> Iterator[Tuple[np.ndarray, Graph]]:
        """One epoch of ``(dataset indices, batch)`` pairs, for callers
        that keep something per batch (a fused operator per graph);
        ``device`` (default the loader's) is where the batches land: a
        captured step collates on the host (``"cpu"``) and copies each
        batch into its static buffers itself."""
        device = self.device if device is None else resolve_device(device)
        for chunk in self._chunks():
            datas = [self.dataset[int(i)] for i in chunk]
            nn_, ne_ = self.num_nodes, self.num_edges
            if self.dynamic_buckets:
                nn_ = min(bucket_size(sum(d.num_nodes for d in datas) + 1),
                          nn_)
                ne_ = min(bucket_size(max(sum(d.num_edges for d in datas),
                                          1)), ne_)
            yield chunk, collate(datas, num_nodes=nn_, num_edges=ne_,
                                 num_graphs=self.num_graphs,
                                 device=device)

    def __iter__(self) -> Iterator[Graph]:
        for _, graph in self.indexed():
            yield graph


class DataListLoader(_Batches):
    """Yields Python lists of host ``Data``: the data-parallel input, each
    device's share collated by the parallel wrapper."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)

    def __iter__(self) -> Iterator[List[Data]]:
        for chunk in self._chunks():
            yield [self.dataset[int(i)] for i in chunk]


class DenseDataLoader(_Batches):
    """Stacks equal-shape dense fields (x, adj, mask, y) along a leading
    batch dimension: DiffPool's input. Needs a ``ToDense`` pre-transform,
    so that every graph has the same dense shapes. 64-bit host arrays
    become 32-bit tensors on ``device``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, device="cuda"):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed)
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator["DenseBatch"]:
        for chunk in self._chunks():
            datas = [self.dataset[int(i)] for i in chunk]
            batch = {}
            for key in datas[0].keys:
                arr = np.stack([np.asarray(d[key]) for d in datas], axis=0)
                if arr.dtype == np.float64:
                    arr = arr.astype(np.float32)
                if arr.dtype == np.int64:
                    arr = arr.astype(np.int32)
                batch[key] = torch.from_numpy(arr).to(self.device)
            yield DenseBatch(batch)


class DenseBatch(dict):
    """Attribute-style access over stacked dense fields."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    @property
    def num_graphs(self):
        for v in self.values():
            return v.shape[0]
        return 0
