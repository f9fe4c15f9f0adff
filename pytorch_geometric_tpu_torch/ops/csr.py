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

A :class:`StaticCsr` is the same layout in buffers sized to a loader's
budget, which a captured CUDA graph reads: each batch's CSR is copied
into them in place (:meth:`StaticCsr.load`). Its real entries end at
``row_ptr[num_rows]``; the slots past that are never read, so
``num_edges`` (the buffers' length) is then the capacity, and the plain
versions sum the first :func:`real_entries` positions.
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


@dataclasses.dataclass(frozen=True)
class StaticCsr(Csr):
    """A CSR in preallocated buffers of ``capacity`` entry slots, loaded
    in place batch after batch (:meth:`load`). The spare slots hold
    column ``num_cols`` (out of range: nothing may read them) and
    ``perm`` 0 (in range: a gather of per-edge weights by ``perm`` runs
    over every slot)."""

    @staticmethod
    def empty(num_rows: int, num_cols: int, capacity: int,
              device) -> "StaticCsr":
        return StaticCsr(
            row_ptr=torch.zeros(num_rows + 1, dtype=torch.int32,
                                device=device),
            col=torch.full((capacity,), num_cols, dtype=torch.int32,
                           device=device),
            perm=torch.zeros(capacity, dtype=torch.int64, device=device),
            num_rows=int(num_rows), num_cols=int(num_cols))

    def load(self, src: Csr) -> "StaticCsr":
        """Copy ``src`` (a CSR of the same rows and columns, on any
        device) into the buffers on the current stream, without waiting
        for the card; the slots past ``src``'s entries keep what they
        held."""
        if (src.num_rows, src.num_cols) != (self.num_rows, self.num_cols):
            raise ValueError(f"a {src.num_rows} x {src.num_cols} CSR does "
                             f"not fit static buffers of {self.num_rows} x "
                             f"{self.num_cols}")
        if src.num_edges > self.num_edges:
            raise ValueError(f"{src.num_edges} entries exceed the static "
                             f"CSR's {self.num_edges} slots")
        for dst, t in ((self.row_ptr, src.row_ptr), (self.col, src.col),
                       (self.perm, src.perm)):
            copy_into(dst, t)
        return self


def copy_into(dst: torch.Tensor, src: torch.Tensor):
    """``dst[:len(src)] = src`` on the current stream without a host
    wait: a host tensor bound for a card is staged in pinned memory
    first (the pinned block is not reused before the copy ends)."""
    if src.device.type == "cpu" and dst.device.type == "cuda":
        src = src.pin_memory()
    dst[:src.shape[0]].copy_(src, non_blocking=True)


def real_entries(csr: Csr) -> int:
    """The entries the rows of ``csr`` hold, ``row_ptr[num_rows]``: read
    from ``row_ptr`` on the CPU (there is no card to wait for) and for a
    :class:`StaticCsr` anywhere (a plain version's read, never inside a
    captured step); otherwise the CSR's length, which it equals."""
    if csr.row_ptr.device.type == "cpu" or isinstance(csr, StaticCsr):
        return int(csr.row_ptr[-1])
    return csr.num_edges


def host_array(a) -> np.ndarray:
    """``a`` (tensor on any device, array or sequence) as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def build_csr(rows, cols, num_rows: int, num_cols: int = None,
              edges=None) -> Csr:
    """CSR of the edges ``(cols[e] -> rows[e])`` grouped by ``rows``, on
    the CPU. The receiver-major operator is ``build_csr(receivers,
    senders, N)``; its transpose is ``build_csr(senders, receivers, N)``.
    ``edges`` (ids into ``rows`` / ``cols``, increasing) keeps those edges
    only: ``perm`` then gives their ids in the full list.
    """
    rows = np.asarray(rows).astype(np.int64, copy=False)
    cols = np.asarray(cols).astype(np.int64, copy=False)
    num_cols = num_rows if num_cols is None else num_cols
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"rows {rows.shape} and cols {cols.shape} must be "
                         "1-D of one length")
    if edges is not None:
        edges = np.asarray(edges, dtype=np.int64)
        rows, cols = rows[edges], cols[edges]
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
        perm=torch.from_numpy(perm if edges is None else edges[perm]),
        num_rows=int(num_rows), num_cols=int(num_cols))
