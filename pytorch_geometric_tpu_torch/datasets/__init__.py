"""Datasets, each with its deterministic synthetic fallback: citation
graphs, relational entities, molecules, superpixels, PPI, the TU
graph-classification corpora, meshes and the large single graphs."""

from pytorch_geometric_tpu_torch.datasets.large_graphs import (  # noqa: F401
    Amazon,
    Reddit,
)
from pytorch_geometric_tpu_torch.datasets.meshes import (  # noqa: F401
    FAUST,
    ModelNet,
)
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

__all__ = ["Amazon", "CITATION_SHAPES", "CoraFull", "Entities", "FAUST",
           "MNISTSuperpixels", "ModelNet", "PPI", "Planetoid", "QM9",
           "Reddit", "TUDataset", "synthetic_citation_graph",
           "synthetic_graph_classification"]
