"""Design probe of the packed-GAT forward and backward, on one NVIDIA GPU.

    python3 probes/packed_gat_designs.py [--calls 50]

Times the two designs of ``packed_gat_fwd`` and of ``packed_gat_bwd``
(``pytorch_geometric_tpu_torch/csrc/packed_gat.cu``) on the same inputs in
one run: the forward (``fwd_first``, ``fwd_shipped``), and the backward,
each walk alone (walk 0 over the receiver-major CSR writes ``dd``; walk 1
over the sender-major CSR, with the edge ids, ``ds`` and ``dh``) and both
together, the call the model makes:

- ``first``: the source's first design, one group of lanes per (row,
  head) walking the row's edges one after another, every lane of the
  group forming each edge's terms (``gat_fwd_kernel``,
  ``gat_bwd_heads_kernel``, launched at every width by
  ``first_packed_gat_fwd`` and ``first_packed_gat_bwd`` of
  ``probes/packed_gat_designs.cu``);
- ``shipped``: the port's library, one sub-warp per CSR row over all
  heads, each edge's index and (edge, head) terms loaded and formed once,
  whole-row gathers (``gat_fwd_rows_kernel``, ``gat_bwd_kernel``, at the
  widths where the lane map covers a row in one pass; the first design
  elsewhere).

Cases: Cora (``datasets/graphs.py:cora_graph``: 3072 rows, ~13.6k edges)
at conv1's (H, C) = (8, 8), attention dropout 0 and 0.6, and conv2's
(1, 7); PubMed after RCM (``pubmed_graph``: 24,576 rows, ~113.2k edges)
at (8, 8), dropout 0 and 0.6, and (1, 3); the hub graph
(``gat_hub_edges``: 512 rows, a receiver of 500 senders, a sender of 400
receivers) at (8, 8), (1, 7) and (3, 5), dropout 0.6.

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), one with the launch floor
(``probes/common.py:floor_line``: an empty kernel's plain launch, timed
the same way), then one per case: device µs of each design's forward and
of each backward walk and call with the L2 warm and flushed (median of
five CUDA-graph timings of ``--calls`` calls, and their spread,
``probes/common.py:timings``), the forward's bound (``bounds.py:gat_bound``),
each walk's (``gat_walk_bound``) and the backward call's, the largest
error of each design against the plain version and of the first against
the shipped one (relative to the largest magnitude; ``fwd_*``: the
forward's num‖den), whether two launches of the shipped forward are
bitwise equal, the row lengths of both CSRs, and the card's name and
power limit. Exits non-zero without a card.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import (  # noqa: E402
    build_line, card, emit, floor_line, require_card, row_lengths, timings)

SOURCE = REPO / "probes" / "packed_gat_designs.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
SIGNATURES = {
    "first_packed_gat_fwd": (_I, [_P] * 8 + [_I] * 3 + [_U, _F, _F, _P]),
    "first_packed_gat_bwd": (_I, [_P] * 11 + [_I] * 3
                             + [_U, _F, _F, _I, _P]),
}
DESIGNS = ("first", "shipped")
#: (graph, H, C, dropout rate) of each case.
CASES = (("cora", 8, 8, 0.0), ("cora", 8, 8, 0.6), ("cora", 1, 7, 0.6),
         ("pubmed_rcm", 8, 8, 0.0), ("pubmed_rcm", 8, 8, 0.6),
         ("pubmed_rcm", 1, 3, 0.6), ("hub", 8, 8, 0.6), ("hub", 1, 7, 0.6),
         ("hub", 3, 5, 0.6))
SEED = 0
GAT_SEED = 123457


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def entry(lib, design):
    """The C entry point of one walk of a design (packed_gat_bwd's
    signature): the probe's first design, or the port's library."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design == "first":
        return lib.first_packed_gat_bwd
    return load_library("packed_gat").packed_gat_bwd


def fwd_entry(lib, design):
    """The C entry point of a forward design (packed_gat_fwd's
    signature): the probe's first design, or the port's library."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design not in DESIGNS:
        raise ValueError(f"unknown forward design {design!r}")
    if design == "first":
        return lib.first_packed_gat_fwd
    return load_library("packed_gat").packed_gat_fwd


def fwd(fn, op, inputs, rate, out=None):
    """The raw num‖den and the shift's m of the forward through the C
    entry point ``fn`` (see :func:`fwd_entry`) over the receiver-major
    CSR, into ``out``, a pair (made from torch.empty if None)."""
    from pytorch_geometric_tpu_torch.ops.packed_gat import _launch_args

    d, s, h, _, seed = inputs[:5]
    n, H = d.shape
    C = h.shape[1] // H
    if out is None:
        out = (torch.empty((n, H * C + H), dtype=torch.float32,
                           device=d.device), torch.empty_like(d))
    rc = fn(op.fwd.row_ptr.data_ptr(), op.fwd.col.data_ptr(), d.data_ptr(),
            s.data_ptr(), h.data_ptr(), out[1].data_ptr(), seed.data_ptr(),
            out[0].data_ptr(), n, H, C,
            *_launch_args(rate, op.slope,
                          torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"packed_gat_fwd failed: CUDA error {rc}")
    return out


def compare_fwd(lib, op, inputs, rate):
    """Both forward designs against the plain versions (num‖den and m)
    and the first against the shipped one (relative to the largest
    reference magnitude), and whether two launches of the shipped design
    are bitwise equal: ``(errors, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    d, s, h, m, seed = inputs[:5]
    plain = (pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed, rate,
                                     op.slope), m)
    got = {design: fwd(fwd_entry(lib, design), op, inputs, rate)
           for design in DESIGNS}
    again = fwd(fwd_entry(lib, "shipped"), op, inputs, rate)
    torch.cuda.synchronize()
    errors = {f"fwd_{design}_vs_plain": _rel(out, plain)
              for design, out in got.items()}
    errors["fwd_first_vs_shipped"] = _rel(got["first"], got["shipped"])
    return errors, all(torch.equal(a, b)
                       for a, b in zip(again, got["shipped"]))


def bwd_walk(fn, op, inputs, rate, walk, outs=None):
    """One walk of the backward through the C entry point ``fn`` (see
    :func:`entry`) into ``outs`` (made from torch.empty if None): walk 0
    gives ``(dd,)``, walk 1 ``(ds, dh)``."""
    from pytorch_geometric_tpu_torch.ops.packed_gat import _launch_args

    d, s, h, m, seed, g = inputs
    n, H = d.shape
    C = h.shape[1] // H
    if outs is None:
        outs = ((torch.empty_like(d),) if walk == 0
                else (torch.empty_like(d), torch.empty_like(h)))
    csr, eid = (op.fwd, None) if walk == 0 else (op.bwd, op.bwd_eid)
    tail = _launch_args(rate, op.slope,
                        torch.cuda.current_stream().cuda_stream)
    rc = fn(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(),
        None if eid is None else eid.data_ptr(), d.data_ptr(), s.data_ptr(),
        h.data_ptr(), m.data_ptr(), g.data_ptr(), seed.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr() if walk else None, n, H, C,
        *tail[:3], walk, tail[3])
    if rc != 0:
        raise RuntimeError(f"packed_gat_bwd (walk {walk}) failed: CUDA "
                           f"error {rc}")
    return outs


def bwd(fn, op, inputs, rate, outs=None):
    """Both walks through ``fn``: ``(dd, ds, dh)``, into ``outs`` (a pair
    of :func:`bwd_walk` outputs)."""
    outs = outs or (None, None)
    return (bwd_walk(fn, op, inputs, rate, 0, outs[0])
            + bwd_walk(fn, op, inputs, rate, 1, outs[1]))


def inputs(op, H, C, gen):
    """Random d, s, h, g at (H, C) over ``op``'s rows, the shift's m (each
    receiver's max of s over its senders, as the forward gives it) and
    the dropout seed: ``(d, s, h, m, seed, g)``."""
    from pytorch_geometric_tpu_torch.ops.packed_gat import receiver_max

    n = op.n
    d, s = (torch.randn(n, H, generator=gen, device="cuda")
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device="cuda")
    g = torch.randn(n, H * C + H, generator=gen, device="cuda")
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device="cuda")
    return d, s, h, receiver_max(op.fwd, s), seed, g


def _rel(got, want):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def compare(lib, op, H, C, rate, gen):
    """Both designs' backward on random inputs at (H, C) against the plain
    version and each other: ``(inputs, errors)``, errors relative to the
    largest reference magnitude."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    args = inputs(op, H, C, gen)
    d, s, h, m, seed, g = args
    plain = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g, rate,
                                    op.slope)
    got = {design: bwd(entry(lib, design), op, args, rate)
           for design in DESIGNS}
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel(out, plain)
              for design, out in got.items()}
    errors["first_vs_shipped"] = _rel(got["first"], got["shipped"])
    return args, errors


def ops():
    """{name: PackedFlashGat} of the probe's graphs, on the card."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, gat_hub_edges, pubmed_graph)
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat

    hub_s, hub_r = gat_hub_edges()
    return {"cora": gat_flash_op(cora_graph("cuda")[1]),
            "pubmed_rcm": gat_flash_op(pubmed_graph("cuda")[1]),
            "hub": PackedFlashGat(senders=hub_s, receivers=hub_r,
                                  num_nodes=512, device="cuda")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not require_card("packed_gat_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import gat_bound, gat_walk_bound

    smi = card()
    emit(build_line("packed_gat_designs", SOURCE, smi))
    emit(floor_line("packed_gat_designs", args.calls, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for graph, op in ops().items():
        for name, H, C, rate in CASES:
            if name != graph:
                continue
            data, errors = compare(lib, op, H, C, rate, gen)
            fwd_errors, fwd_repeat = compare_fwd(lib, op, data, rate)
            line = {"probe": "packed_gat_designs", "graph": graph,
                    "rows": op.n, "edges": op.E, "H": H, "C": C,
                    "rate": rate, "errors": {**fwd_errors, **errors},
                    "fwd_bitwise_repeat": fwd_repeat,
                    "row_lengths": {"receiver": row_lengths(op.fwd.row_ptr),
                                    "sender": row_lengths(op.bwd.row_ptr)}}
            for design in DESIGNS:
                fn = fwd_entry(lib, design)
                out = fwd(fn, op, data, rate)
                line[f"fwd_{design}"] = timings(
                    lambda: fwd(fn, op, data, rate, out), args.calls)
            line["fwd_bound_ms"], line["fwd_bound_by"] = gat_bound(
                op, H, C, False)
            for design in DESIGNS:
                fn = entry(lib, design)
                outs = tuple(bwd_walk(fn, op, data, rate, walk)
                             for walk in (0, 1))
                for walk in (0, 1):
                    line[f"{design}_walk{walk}"] = timings(
                        lambda: bwd_walk(fn, op, data, rate, walk,
                                         outs[walk]), args.calls)
                line[design] = timings(
                    lambda: bwd(fn, op, data, rate, outs), args.calls)
            for walk in (0, 1):
                line[f"walk{walk}_bound_ms"], line["bound_by"] = \
                    gat_walk_bound(op, H, C, walk)
            line["bound_ms"] = gat_bound(op, H, C, True)[0]
            emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
