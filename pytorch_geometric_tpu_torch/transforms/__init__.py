"""Data -> Data transforms."""

from pytorch_geometric_tpu_torch.transforms.normalize_features import (  # noqa: F401
    NormalizeFeatures,
)

__all__ = ["NormalizeFeatures"]
