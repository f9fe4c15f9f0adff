"""Graph convolutions."""

from pytorch_geometric_tpu_torch.nn.conv.gat_conv import (  # noqa: F401
    GATConv,
    gat_dense_adj,
    gat_edge_set,
)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (  # noqa: F401
    EdgeNorm,
    GCNConv,
    gcn_norm,
    gcn_norm_dense,
)

from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import (  # noqa: F401
    RGCNConv,
    rgcn_fused_op,
    rgcn_norm,
)

__all__ = ["EdgeNorm", "GATConv", "GCNConv", "RGCNConv", "gat_dense_adj",
           "gat_edge_set", "gcn_norm", "gcn_norm_dense", "rgcn_fused_op",
           "rgcn_norm"]
