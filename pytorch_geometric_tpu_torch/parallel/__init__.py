"""Parallelism: rank processes and meshes, data parallelism, graph
partitioning.

Counterpart of ``pytorch_geometric_tpu/parallel/`` (reference:
``torch_geometric.nn.DataParallel`` over NCCL, examples/
data_parallel.py). One process per rank in a ``torch.distributed``
group (``mesh.RankPool``): NCCL on the cards, gloo on the CPU.
Gradients are averaged over the ranks in rank order
(``data_parallel.py``), and an edge-partitioned graph exchanges its halo
rows by all-to-all (``partition.py``, ``fast.py``, ``api.py``).
"""

from pytorch_geometric_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from pytorch_geometric_tpu_torch.parallel.data_parallel import (  # noqa: F401
    stack_graphs,
    shard_data_list,
    DataParallelTrainer,
)
from pytorch_geometric_tpu_torch.parallel.api import (  # noqa: F401
    GraphPartition,
    ShardCtx,
)
from pytorch_geometric_tpu_torch.parallel.fast import (  # noqa: F401
    PartitionedSpmm,
)
from pytorch_geometric_tpu_torch.parallel.models import (  # noqa: F401
    DistGAT,
    DistGCN,
    DistRGCN,
    DistSAGE,
)

__all__ = ["make_mesh", "stack_graphs", "shard_data_list",
           "DataParallelTrainer", "GraphPartition", "ShardCtx",
           "PartitionedSpmm", "DistGCN", "DistSAGE", "DistGAT",
           "DistRGCN"]
