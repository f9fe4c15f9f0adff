"""Model wrappers (reference: torch_geometric.nn models, SURVEY §1-L4.3).
Counterpart of ``pytorch_geometric_tpu/nn/models/``."""

from pytorch_geometric_tpu_torch.nn.models.autoencoder import (  # noqa: F401
    GAE,
    VGAE,
    InnerProductDecoder,
    average_precision_score,
    negative_sampling,
    roc_auc_score,
    split_edges,
)
from pytorch_geometric_tpu_torch.nn.models.infomax import (  # noqa: F401
    DeepGraphInfomax,
    InfomaxHead,
    infomax_loss_fn,
)

__all__ = ["GAE", "VGAE", "InnerProductDecoder", "split_edges",
           "negative_sampling", "DeepGraphInfomax", "InfomaxHead",
           "infomax_loss_fn", "roc_auc_score", "average_precision_score"]
