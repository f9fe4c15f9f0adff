"""Datasets, each with its deterministic synthetic fallback: citation
graphs, relational entities, molecules, superpixels, PPI and the TU
graph-classification corpora."""

from pytorch_geometric_tpu_torch.datasets.molecules import (  # noqa: F401
    QM9,
    Entities,
    MNISTSuperpixels,
)
from pytorch_geometric_tpu_torch.datasets.planetoid import (  # noqa: F401
    CoraFull,
    Planetoid,
)
from pytorch_geometric_tpu_torch.datasets.ppi import PPI  # noqa: F401
from pytorch_geometric_tpu_torch.datasets.synthetic import (  # noqa: F401
    CITATION_SHAPES,
    synthetic_citation_graph,
    synthetic_graph_classification,
)
from pytorch_geometric_tpu_torch.datasets.tu_dataset import (  # noqa: F401
    TUDataset,
)

__all__ = ["CITATION_SHAPES", "CoraFull", "Entities", "MNISTSuperpixels",
           "PPI", "Planetoid", "QM9", "TUDataset", "synthetic_citation_graph",
           "synthetic_graph_classification"]
