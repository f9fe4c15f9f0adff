"""Dataset base classes: ``Dataset``, ``Subset``, ``InMemoryDataset`` and
its column view ``DataView``.

Counterpart of ``pytorch_geometric_tpu/data/dataset.py`` (reference
usage: examples/mutag_gin.py:11-13 slicing and ``shuffle()``,
examples/qm9_nn_conv.py:55-57 in-place ``.data`` mutation,
examples/enzymes_diff_pool.py:62 ``pre_filter``).

The JAX package caches processed records as a pickle under
``<root>/processed/``; the port does not: it never unpickles a file it
did not write in the same process (the JAX package's pickles hold
``pytorch_geometric_tpu.data.data.Data`` and would import that package),
and building the corpora takes seconds at most. ``process_full`` therefore
runs on every construction, ``pre_filter`` and then ``pre_transform``
apply to its records as the JAX ``InMemoryDataset.process`` applies them,
and nothing is written under ``root``. No download is attempted.
"""

import os.path as osp
from typing import Callable, List, Optional

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data


class Dataset:
    """A dataset of host ``Data`` records rooted at a path.

    Subclasses implement ``len`` and ``get``. Indexing by an int returns
    one record (``transform`` applied to a clone, so it never mutates the
    stored record); by a slice, a boolean mask or an index array it
    returns a :class:`Subset`."""

    def __init__(self, root: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None,
                 pre_filter: Optional[Callable] = None):
        self.root = osp.expanduser(root) if root else None
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter

    # --- to override ------------------------------------------------------

    @property
    def raw_file_names(self) -> List[str]:
        raise NotImplementedError

    def len(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> Data:
        raise NotImplementedError

    # --- paths ------------------------------------------------------------

    @property
    def raw_dir(self) -> str:
        return osp.join(self.root, "raw")

    @property
    def raw_paths(self) -> List[str]:
        return [osp.join(self.raw_dir, f) for f in self.raw_file_names]

    # --- access -----------------------------------------------------------

    def __len__(self) -> int:
        return self.len()

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            data = self.get(int(idx))
            if self.transform is None:
                return data
            return self.transform(data.clone())
        return self.index_select(idx)

    def index_select(self, idx) -> "Subset":
        """The records at ``idx``: a slice, a boolean mask over the
        dataset or an array of indices."""
        if isinstance(idx, slice):
            idx = np.arange(self.len())[idx]
        elif isinstance(idx, np.ndarray) and idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return Subset(self, np.asarray(idx, dtype=np.int64))

    def shuffle(self, seed: Optional[int] = None) -> "Subset":
        """A random order of the records, from
        ``np.random.default_rng(seed).permutation``."""
        perm = np.random.default_rng(seed).permutation(self.len())
        return Subset(self, perm)

    @property
    def num_node_features(self) -> int:
        return self[0].num_node_features

    num_features = num_node_features

    @property
    def num_edge_features(self) -> int:
        return self[0].num_edge_features

    @property
    def num_classes(self) -> int:
        ys = []
        for i in range(self.len()):
            y = self.get(i).y
            if y is not None:
                ys.append(np.atleast_1d(y))
        if not ys:
            return 0
        y = np.concatenate(ys)
        if np.issubdtype(y.dtype, np.floating) and y.ndim > 1:
            return y.shape[-1]
        return int(y.max()) + 1

    def __repr__(self):
        return f"{self.__class__.__name__}({self.len()})"


class Subset(Dataset):
    """Index-selected view over a dataset (a slice or a shuffle)."""

    def __init__(self, dataset: Dataset, indices: np.ndarray):
        self.dataset = dataset
        self.indices = indices
        self.root = dataset.root
        self.transform = None   # the parent's transform applies in get
        self.pre_transform = dataset.pre_transform
        self.pre_filter = dataset.pre_filter

    def len(self):
        return len(self.indices)

    def get(self, idx):
        return self.dataset[int(self.indices[idx])]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.get(int(idx))
        return self.index_select(idx)

    @property
    def num_classes(self):
        return self.dataset.num_classes


class InMemoryDataset(Dataset):
    """Holds the full list of host ``Data`` records in memory.

    Subclasses implement ``raw_file_names`` and ``process_full() ->
    List[Data]``; the records that ``pre_filter`` keeps, each through
    ``pre_transform``, are stored in ``data_list``."""

    def __init__(self, root: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None,
                 pre_filter: Optional[Callable] = None):
        super().__init__(root, transform, pre_transform, pre_filter)
        data_list = self.process_full()
        if pre_filter is not None:
            data_list = [d for d in data_list if pre_filter(d)]
        if pre_transform is not None:
            data_list = [pre_transform(d) for d in data_list]
        self.data_list: List[Data] = data_list

    def process_full(self) -> List[Data]:
        raise NotImplementedError

    def len(self) -> int:
        return len(self.data_list)

    def get(self, idx: int) -> Data:
        return self.data_list[idx]

    @property
    def data(self) -> "DataView":
        """Column view over all records: ``dataset.data.y`` is the field
        concatenated; assigning to it writes back through to the records
        (examples/qm9_nn_conv.py:55-57)."""
        return DataView(self)


class DataView:
    """``InMemoryDataset.data``: each field of the records concatenated
    (``edge_index`` and ``face`` along axis 1, the rest along axis 0)."""

    def __init__(self, dataset: InMemoryDataset):
        object.__setattr__(self, "_ds", dataset)

    def __getattr__(self, key):
        vals = [getattr(d, key, None) for d in self._ds.data_list]
        if all(v is None for v in vals):
            raise AttributeError(key)
        axis = 1 if key in ("edge_index", "face") else 0
        return np.concatenate([np.atleast_1d(v) for v in vals], axis=axis)

    def __setattr__(self, key, value):
        value = np.asarray(value)
        off = 0
        axis = 1 if key in ("edge_index", "face") else 0
        for d in self._ds.data_list:
            n = np.atleast_1d(getattr(d, key)).shape[axis]
            sl = [slice(None)] * value.ndim
            sl[axis] = slice(off, off + n)
            setattr(d, key, value[tuple(sl)])
            off += n
