"""Data -> Data transforms."""

from pytorch_geometric_tpu_torch.transforms.compose import Compose  # noqa: F401
from pytorch_geometric_tpu_torch.transforms.geometry import (  # noqa: F401
    Cartesian,
    Distance,
    Polar,
    TargetIndegree,
)
from pytorch_geometric_tpu_torch.transforms.normalize_features import (  # noqa: F401
    NormalizeFeatures,
)
from pytorch_geometric_tpu_torch.transforms.points import (  # noqa: F401
    Center,
    FaceToEdge,
    NormalizeScale,
    RandomTranslate,
    SamplePoints,
)
from pytorch_geometric_tpu_torch.transforms.structure import (  # noqa: F401
    AddSelfLoops,
    Constant,
    OneHotDegree,
    ToDense,
)

__all__ = ["AddSelfLoops", "Cartesian", "Center", "Compose", "Constant",
           "Distance", "FaceToEdge", "NormalizeFeatures", "NormalizeScale",
           "OneHotDegree", "Polar", "RandomTranslate", "SamplePoints",
           "TargetIndegree", "ToDense"]
