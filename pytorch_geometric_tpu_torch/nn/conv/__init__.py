"""Graph convolutions."""

from pytorch_geometric_tpu_torch.nn.conv.agnn_conv import (  # noqa: F401
    AGNNConv,
    agnn_edge_set,
    agnn_operators,
)
from pytorch_geometric_tpu_torch.nn.conv.arma_conv import (  # noqa: F401
    ARMAConv,
    arma_edge_set,
    arma_operator,
)
from pytorch_geometric_tpu_torch.nn.conv.cheb_conv import (  # noqa: F401
    ChebConv,
    cheb_operator,
)
from pytorch_geometric_tpu_torch.nn.conv.dna_conv import (  # noqa: F401
    DNAConv,
    dna_operators,
)
from pytorch_geometric_tpu_torch.nn.conv.edge_conv import EdgeConv  # noqa: F401
from pytorch_geometric_tpu_torch.nn.conv.gat_conv import (  # noqa: F401
    GATConv,
    gat_closure_op,
    gat_dense_adj,
    gat_edge_set,
    gat_sparse_edge_set,
)
from pytorch_geometric_tpu_torch.nn.conv.gcn_conv import (  # noqa: F401
    EdgeNorm,
    GCNConv,
    gcn_closure_norm,
    gcn_closure_operator,
    gcn_edge_set,
    gcn_norm,
    gcn_norm_dense,
)
from pytorch_geometric_tpu_torch.nn.conv.gin_conv import GINConv  # noqa: F401
from pytorch_geometric_tpu_torch.nn.conv.graph_conv import GraphConv  # noqa: F401
from pytorch_geometric_tpu_torch.nn.conv.nn_conv import NNConv  # noqa: F401
from pytorch_geometric_tpu_torch.nn.conv.point_conv import PointConv  # noqa: F401
from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import (  # noqa: F401
    RGCNConv,
    rgcn_closure_norm,
    rgcn_closure_op,
    rgcn_fused_op,
    rgcn_norm,
)
from pytorch_geometric_tpu_torch.nn.conv.sage_conv import (  # noqa: F401
    DenseSAGEConv,
    SAGEConv,
)
from pytorch_geometric_tpu_torch.nn.conv.sg_conv import (  # noqa: F401
    SGConv,
    sgc_precompute,
)
from pytorch_geometric_tpu_torch.nn.conv.spline_conv import (  # noqa: F401
    SplineConv,
    spline_basis,
    spline_edge_sets,
    spline_operator,
    spline_operators,
)

__all__ = ["AGNNConv", "ARMAConv", "ChebConv", "DNAConv", "DenseSAGEConv",
           "EdgeConv", "EdgeNorm", "GATConv", "GCNConv", "GINConv",
           "GraphConv", "NNConv", "PointConv", "RGCNConv", "SAGEConv",
           "SGConv", "SplineConv", "agnn_edge_set", "agnn_operators",
           "arma_edge_set", "arma_operator", "cheb_operator", "dna_operators",
           "gat_closure_op", "gat_dense_adj", "gat_edge_set",
           "gat_sparse_edge_set", "gcn_closure_norm", "gcn_closure_operator",
           "gcn_edge_set", "gcn_norm", "gcn_norm_dense", "rgcn_closure_norm",
           "rgcn_closure_op", "rgcn_fused_op", "rgcn_norm", "sgc_precompute",
           "spline_basis", "spline_edge_sets", "spline_operator",
           "spline_operators"]
