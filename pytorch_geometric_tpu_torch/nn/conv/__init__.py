"""Graph convolutions."""

from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (  # noqa: F401
    EdgeNorm,
    GCNConv,
    gcn_norm,
    gcn_norm_dense,
)

__all__ = ["EdgeNorm", "GCNConv", "gcn_norm", "gcn_norm_dense"]
