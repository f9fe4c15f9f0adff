"""Data -> Data transforms."""

from pytorch_geometric_tpu_torch.transforms.geometry import (  # noqa: F401
    Cartesian,
    Distance,
    Polar,
    TargetIndegree,
)
from pytorch_geometric_tpu_torch.transforms.normalize_features import (  # noqa: F401
    NormalizeFeatures,
)

__all__ = ["Cartesian", "Distance", "NormalizeFeatures", "Polar",
           "TargetIndegree"]
