"""Pooling layers (reference: the torch_geometric.nn pooling family,
SURVEY §1-L4.2). Counterpart of ``pytorch_geometric_tpu/nn/pool/``."""

from pytorch_geometric_tpu_torch.nn.pool.global_pool import (  # noqa: F401
    global_add_pool,
    global_mean_pool,
    global_max_pool,
    pool_operator,
)
from pytorch_geometric_tpu_torch.nn.pool.topk_pool import (  # noqa: F401
    TopKPooling,
    topk_mask,
)
from pytorch_geometric_tpu_torch.nn.pool.set2set import Set2Set  # noqa: F401
from pytorch_geometric_tpu_torch.nn.pool.diff_pool import (  # noqa: F401
    dense_diff_pool,
)
from pytorch_geometric_tpu_torch.nn.pool.coarsen import (  # noqa: F401
    avg_pool,
    cluster_operator,
    graclus,
    max_pool,
    max_pool_x,
    pool_graph_masked,
)

__all__ = [
    "global_add_pool", "global_mean_pool", "global_max_pool",
    "TopKPooling", "topk_mask", "Set2Set", "dense_diff_pool",
    "graclus", "max_pool", "avg_pool", "max_pool_x", "pool_graph_masked",
    "pool_operator", "cluster_operator",
]
