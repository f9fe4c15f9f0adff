"""Graph utilities."""

from pytorch_geometric_tpu_torch.utils.degree import degree  # noqa: F401
from pytorch_geometric_tpu_torch.utils.loop import add_self_loops  # noqa: F401

__all__ = ["degree", "add_self_loops"]
