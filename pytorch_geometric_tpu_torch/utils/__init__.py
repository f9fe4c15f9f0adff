"""Graph utilities."""

from pytorch_geometric_tpu_torch.utils.convert import (  # noqa: F401
    to_dense_adj, to_dense_batch)
from pytorch_geometric_tpu_torch.utils.degree import degree  # noqa: F401
from pytorch_geometric_tpu_torch.utils.loop import (  # noqa: F401
    add_self_loops, contains_self_loops, remove_self_loops)
from pytorch_geometric_tpu_torch.utils.networkx_convert import (  # noqa: F401
    from_networkx, to_networkx)
from pytorch_geometric_tpu_torch.utils.normalized_cut import (  # noqa: F401
    normalized_cut)
from pytorch_geometric_tpu_torch.utils.reorder import (  # noqa: F401
    rcm_permutation, reorder_graph, window_density)
from pytorch_geometric_tpu_torch.utils.repeat import repeat  # noqa: F401
from pytorch_geometric_tpu_torch.utils.softmax import softmax  # noqa: F401
from pytorch_geometric_tpu_torch.utils.undirected import (  # noqa: F401
    is_undirected, to_undirected)

__all__ = ["degree", "add_self_loops", "remove_self_loops",
           "contains_self_loops", "rcm_permutation", "reorder_graph",
           "window_density", "repeat", "softmax", "to_undirected",
           "is_undirected", "to_dense_adj", "to_dense_batch",
           "normalized_cut", "to_networkx",
           "from_networkx"]
