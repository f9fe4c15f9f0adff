"""Train/val/test index sampling.

Counterpart of ``pytorch_geometric_tpu/data/sampler.py`` (reference:
DataSampler.py, a ``SubsetRandomSampler`` split of a dataset by two
fractions). Host numpy, the same draws as the JAX function.
"""

from typing import Tuple

import numpy as np


def data_sampler(dataset_len: int, train_frac: float = 0.8,
                 val_frac: float = 0.1, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffled (train_idx, val_idx, test_idx) index split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(dataset_len)
    n_train = int(train_frac * dataset_len)
    n_val = int(val_frac * dataset_len)
    return (perm[:n_train], perm[n_train:n_train + n_val],
            perm[n_train + n_val:])
