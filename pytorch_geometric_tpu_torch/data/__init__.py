"""Graph data core: padded ``Graph`` of tensors, host ``Data`` records,
datasets and loaders."""

from pytorch_geometric_tpu_torch.data.graph import (  # noqa: F401
    Graph, from_edge_index)
from pytorch_geometric_tpu_torch.data.data import Data  # noqa: F401
from pytorch_geometric_tpu_torch.data.batch import (  # noqa: F401
    bucket_size,
    collate,
    from_data,
)
from pytorch_geometric_tpu_torch.data.dataset import (  # noqa: F401
    Dataset,
    DataView,
    InMemoryDataset,
    Subset,
)
from pytorch_geometric_tpu_torch.data.loader import (  # noqa: F401
    DataListLoader,
    DataLoader,
    DenseBatch,
    DenseDataLoader,
)

__all__ = ["Graph", "Data", "from_edge_index", "bucket_size", "collate",
           "from_data", "Dataset", "DataView", "InMemoryDataset", "Subset",
           "DataListLoader", "DataLoader", "DenseBatch", "DenseDataLoader"]
