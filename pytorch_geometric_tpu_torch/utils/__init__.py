"""Graph utilities."""

from pytorch_geometric_tpu_torch.utils.degree import degree  # noqa: F401
from pytorch_geometric_tpu_torch.utils.loop import add_self_loops  # noqa: F401
from pytorch_geometric_tpu_torch.utils.reorder import (  # noqa: F401
    rcm_permutation, reorder_graph, window_density)

__all__ = ["degree", "add_self_loops", "rcm_permutation", "reorder_graph",
           "window_density"]
