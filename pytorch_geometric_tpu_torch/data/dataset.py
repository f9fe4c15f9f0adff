"""Dataset base class: the ``InMemoryDataset`` surface Planetoid needs.

Counterpart of ``pytorch_geometric_tpu/data/dataset.py``. The JAX
package caches processed records as a pickle under
``<root>/processed/``; the port does not: it never unpickles a file it
did not write in the same process (the JAX package's pickles hold
``pytorch_geometric_tpu.data.data.Data`` and would import that package),
and parsing a citation corpus takes well under a second. ``process_full``
therefore runs on every construction, and nothing is written under
``root``.
"""

import os.path as osp
from typing import Callable, List, Optional

import numpy as np

from pytorch_geometric_tpu_torch.data.data import Data


class InMemoryDataset:
    """Holds the full list of host ``Data`` records in memory.

    Subclasses implement ``raw_file_names`` and ``process_full() ->
    List[Data]``. ``transform`` applies at access time to a clone, so it
    never mutates the stored records; ``pre_transform`` applies once."""

    def __init__(self, root: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None):
        self.root = osp.expanduser(root) if root else None
        self.transform = transform
        self.pre_transform = pre_transform
        data_list = self.process_full()
        if pre_transform is not None:
            data_list = [pre_transform(d) for d in data_list]
        self.data_list: List[Data] = data_list

    # --- to override ------------------------------------------------------

    @property
    def raw_file_names(self) -> List[str]:
        raise NotImplementedError

    def process_full(self) -> List[Data]:
        raise NotImplementedError

    # --- paths ------------------------------------------------------------

    @property
    def raw_dir(self) -> str:
        return osp.join(self.root, "raw")

    @property
    def raw_paths(self) -> List[str]:
        return [osp.join(self.raw_dir, f) for f in self.raw_file_names]

    # --- access -----------------------------------------------------------

    def len(self) -> int:
        return len(self.data_list)

    def get(self, idx: int) -> Data:
        return self.data_list[idx]

    def __len__(self) -> int:
        return self.len()

    def __getitem__(self, idx: int) -> Data:
        data = self.get(int(idx))
        if self.transform is None:
            return data
        return self.transform(data.clone())

    @property
    def num_node_features(self) -> int:
        return self[0].num_node_features

    num_features = num_node_features

    @property
    def num_classes(self) -> int:
        ys = [np.atleast_1d(d.y) for d in self.data_list if d.y is not None]
        if not ys:
            return 0
        y = np.concatenate(ys)
        if np.issubdtype(y.dtype, np.floating) and y.ndim > 1:
            return y.shape[-1]
        return int(y.max()) + 1

    def __repr__(self):
        return f"{self.__class__.__name__}({self.len()})"
