"""Citation datasets, with the deterministic synthetic fallback."""

from pytorch_geometric_tpu_torch.datasets.planetoid import Planetoid  # noqa: F401
from pytorch_geometric_tpu_torch.datasets.synthetic import (  # noqa: F401
    CITATION_SHAPES,
    synthetic_citation_graph,
)

__all__ = ["Planetoid", "CITATION_SHAPES", "synthetic_citation_graph"]
