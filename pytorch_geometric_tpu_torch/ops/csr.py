"""Host CSR build for the SpMM kernel.

Replaces ``pytorch_geometric_tpu/ops/pack.py``: the JAX package packs
edges into (source window, destination window) tiles for the TPU's
one-hot matrix products. On the GPU one row-parallel CSR kernel takes
all the edges, so the host only has to group edges by output row:

- ``row_ptr`` int32 (R+1,): row r owns positions ``row_ptr[r]`` to
  ``row_ptr[r+1]`` (bincount of the rows, then a prefix sum);
- ``col`` int32 (E,): the column (source row of ``x``) at each position;
- ``perm`` int64 (E,): the original edge id at each position, so
  per-edge weights are routed with ``weights[perm]``.

Positions within a row keep the original edge order (a stable sort by
row). Duplicate edges are kept, so they sum, as in the JAX package's
multigraph semantics.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Csr:
    row_ptr: torch.Tensor    # (num_rows + 1,) int32
    col: torch.Tensor        # (E,) int32
    perm: torch.Tensor       # (E,) int64
    num_rows: int
    num_cols: int

    @property
    def num_edges(self) -> int:
        return self.col.shape[0]

    def to(self, device) -> "Csr":
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(device), col=self.col.to(device),
            perm=self.perm.to(device))


def host_array(a) -> np.ndarray:
    """``a`` (tensor on any device, array or sequence) as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def build_csr(rows, cols, num_rows: int, num_cols: int = None) -> Csr:
    """CSR of the edges ``(cols[e] -> rows[e])`` grouped by ``rows``, on
    the CPU. The receiver-major operator is ``build_csr(receivers,
    senders, N)``; its transpose is ``build_csr(senders, receivers, N)``.
    """
    rows = np.asarray(rows).astype(np.int64, copy=False)
    cols = np.asarray(cols).astype(np.int64, copy=False)
    num_cols = num_rows if num_cols is None else num_cols
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"rows {rows.shape} and cols {cols.shape} must be "
                         "1-D of one length")
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        raise ValueError(f"row index out of range [0, {num_rows})")
    if cols.size and (cols.min() < 0 or cols.max() >= num_cols):
        raise ValueError(f"column index out of range [0, {num_cols})")
    if rows.size >= 2 ** 31:
        raise ValueError("more than 2^31 - 1 edges: int32 row pointers "
                         "cannot address them")
    counts = np.bincount(rows, minlength=num_rows)
    row_ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    perm = np.argsort(rows, kind="stable")
    return Csr(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        col=torch.from_numpy(cols[perm].astype(np.int32)),
        perm=torch.from_numpy(perm),
        num_rows=int(num_rows), num_cols=int(num_cols))
