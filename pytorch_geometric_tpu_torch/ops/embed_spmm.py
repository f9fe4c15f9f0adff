"""Table-gather SpMM operators.

Counterpart of ``pytorch_geometric_tpu/ops/embed_spmm.py``:

- :class:`EmbedSpmm`: ``out[r] = sum_{e -> r} w_e * table[id_e]`` into
  ``num_out`` rows, differentiable in the (T, C) ``table``. The JAX
  operator gathers and segment-sums forward, and sums ``d table`` over
  edges sorted by id. Here both directions are one rectangular
  ``spmm_csr`` (``ops/spmm.py:spmm_bi_static``): the (num_out x T) CSR of
  the edges forward, its transpose for ``d table``, both fp32, built on
  the host once by ``pack_bipartite_tables``. On a CUDA tensor each call
  launches the kernel once a direction; on a CPU tensor the kernel's
  plain version runs.
- :data:`RgcnBasisSpmm`: the JAX package's basis-contraction RGCN
  operator, whose call contract (``op(xB2d, att)``, with ``dxB`` and
  ``datt``) is ``PackedRgcnSpmm``'s. It is that class under the
  reference's name, not a second copy of the plain math: the packed-RGCN
  kernels on a CUDA graph, their plain versions on a CPU one.
"""

from typing import Optional

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.packed_rgcn import PackedRgcnSpmm
from pytorch_geometric_tpu_torch.ops.spmm import (
    BiSpmmGeom, pack_bipartite_tables, spmm_bi_static)

#: The JAX ``RgcnBasisSpmm``: same constructor (``senders``, ``receivers``,
#: ``edge_type``, ``num_relations``, ``num_nodes``, ``weights``,
#: ``num_src_rows``) and call, plus the port's ``device``.
RgcnBasisSpmm = PackedRgcnSpmm


class EmbedSpmm:
    """``out = segment_sum(w * table[ids], receivers, num_out)`` over one
    static edge list, built once on the host; every array on ``device``.

    ``weights`` (None: all 1) are bound at build time, so the operator is
    differentiable in ``table`` only, as the JAX static-weights form.
    ``indices_are_sorted`` is the JAX forward's hint for its segment sum;
    a CSR groups the edges by receiver whatever their order, so it
    changes nothing here.
    """

    def __init__(self, ids, receivers, num_table_rows: int, num_out: int,
                 weights: Optional[np.ndarray] = None,
                 indices_are_sorted: bool = False, device="cuda"):
        ids = host_array(ids).astype(np.int64)
        receivers = host_array(receivers).astype(np.int64)
        self.num_table_rows = int(num_table_rows)
        self.num_out = int(num_out)
        w = np.ones(ids.shape[0], np.float32) if weights is None \
            else host_array(weights).astype(np.float32)
        self.geom, self.consts = pack_bipartite_tables(
            ids, receivers, self.num_table_rows, self.num_out, w,
            compute_dtype=torch.float32, device=device)

    def to(self, device) -> "EmbedSpmm":
        """This operator, its CSRs and values moved to ``device``: an
        operator built on the host (``device="cpu"``) uploaded once."""
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        g = self.geom
        self.geom = BiSpmmGeom.make(g.fwd.to(dev), g.bwd.to(dev), g.n_src,
                                    g.n_dst, g.compute)
        self.consts = {k: v.to(dev) for k, v in self.consts.items()}
        return self

    def __call__(self, table):
        return spmm_bi_static(self.geom, self.consts, table)
