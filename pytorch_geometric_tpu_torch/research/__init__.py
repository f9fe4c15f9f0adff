"""Research layer: the reference fork's own contribution. Counterpart of
``pytorch_geometric_tpu/research/``, with the same re-exports.

- pruning: SVD-based width contraction (ConvexPruning.py pipeline)
- spectral: weight-matrix spectral analysis + Fiedler weight correction
  (SpectralAnalysis.py), over its own weight graph (no networkx)
- link_prediction: the 7 link-prediction scorers (link_prediction.py)
- fiedler_sgd: SGD with algebraic-connectivity regularisation (sgd.py)
- admm: ADMM pruning machinery (utils.py)
- quantization: ADMM / direct / DoReFa quantizers (quantization.py)
- checkpoint: best-metric checkpoint/resume (ConvexPruning.py:78-88,362)
- driver: prune -> rebuild -> correct -> retrain pipeline + Monte-Carlo
  convergence store (ConvexPruning.py:443-576)
"""

from pytorch_geometric_tpu_torch.research import link_prediction  # noqa: F401
from pytorch_geometric_tpu_torch.research.pruning import (  # noqa: F401
    contraction_layer_coefficients,
    find_cutoff_point,
    retain_network_size,
)
from pytorch_geometric_tpu_torch.research.spectral import (  # noqa: F401
    weights_to_adjacency,
    compute_fiedler_vector,
    fiedler_vector_cluster,
    weighted_link_prediction,
    weight_correction,
    power_iteration,
)
from pytorch_geometric_tpu_torch.research.fiedler_sgd import (  # noqa: F401
    algebraic_connectivity,
    fiedler_sgd,
)
from pytorch_geometric_tpu_torch.research.admm import (  # noqa: F401
    admm_loss,
    update_Z,
    update_Z_l1,
    update_U,
    apply_prune,
    print_prune,
)
from pytorch_geometric_tpu_torch.research.quantization import (  # noqa: F401
    direct_quantize,
    dorefa_quantize,
    admm_quantization,
)
from pytorch_geometric_tpu_torch.research.checkpoint import (  # noqa: F401
    CheckpointManager,
)
