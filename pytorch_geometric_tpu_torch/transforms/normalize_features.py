"""Row-normalise node features (reference: transforms.NormalizeFeatures,
examples/gcn.py:11): x_i <- x_i / sum(x_i), rows summing to zero kept."""

import numpy as np


class NormalizeFeatures:
    def __call__(self, data):
        x = data.x
        s = x.sum(axis=-1, keepdims=True)
        s[s == 0] = 1.0
        data.x = (x / s).astype(np.float32)
        return data

    def __repr__(self):
        return "NormalizeFeatures()"
