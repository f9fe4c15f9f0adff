"""Graph data core: padded ``Graph`` of tensors, host ``Data`` records."""

from pytorch_geometric_tpu_torch.data.graph import Graph  # noqa: F401
from pytorch_geometric_tpu_torch.data.data import Data  # noqa: F401
from pytorch_geometric_tpu_torch.data.batch import (  # noqa: F401
    bucket_size,
    collate,
    from_data,
)
from pytorch_geometric_tpu_torch.data.dataset import (  # noqa: F401
    InMemoryDataset,
)

__all__ = ["Graph", "Data", "bucket_size", "collate", "from_data",
           "InMemoryDataset"]
