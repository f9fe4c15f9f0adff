"""Prefetch depths of the packed-RGCN forward kernel, on one NVIDIA GPU.

    python3 probes/rgcn_pipe_probe.py [--shapes 30x16,30x2]
                                      [--depths 1,2,4] [--calls 50]
                                      [--order rcm,as_trained]

Counterpart of ``tools/rgcn_pipe_probe.py``, which timed the TPU forward
against a variant that built the next tile's one-hots in double-buffered
scratch while the current tile's products ran (its ``pipe``, in the
``early`` and ``mid`` orders). The Hopper forward builds no one-hots; its
serial chain is the message walk's dependent loads of each row
(``row_ptr``, then the row's ``xB`` slice and the first batch of ``et``,
``w`` and ``pos``, then the multiply-adds and the stores). ``--depths``
stands in place of ``--orders``: depth 1 is the shipped forward,
``packed_rgcn_fwd`` of ``csrc/packed_rgcn.cu`` itself (``rgcn_msg_kernel``
over the sender-major CSR, then the segment sum); depths 2 and 4 run
``rgcn_msg_ahead_kernel`` (``probes/packed_rgcn_ablate.cu``), that walk
with the next D - 1 rows' ``xB`` slices and first batches requested
before a row's multiply-adds, in the grid-stride order, and the same
segment sum. The sums keep their order, so every depth gives the
library's bits.

The graph is MUTAG-RDF at full size in each ``--order``
(``pytorch_geometric_tpu_torch/datasets/graphs.py``), the edges and
weights of the conv1 operator that ``train_rgcn`` builds (embed mode,
24,576 source rows); each ``--shapes`` entry BxC is one xB (24,576, B*C)
and att (46, B). After them, the hub operator
(``datasets/graphs.py:rgcn_hub_operator``) at (5, 33). Before timing,
depth 1 is checked bitwise against the library's ``packed_rgcn_fwd`` and
within 1e-5 (relative to the largest magnitude) of
``packed_rgcn_fwd_plain``, and every depth bitwise against depth 1, as
the tool asserts its parity before timing. One JSON line per order,
shape and depth: device µs per call (both launches) and ns per edge with
the L2 warm and flushed (median of five CUDA-graph timings of ``--calls``
calls, and their spread), the bound, the walked CSRs' row lengths, and
the card's name and power limit. Exits non-zero without a card.
"""

import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import (  # noqa: E402
    build_line, card, emit, require_card, row_lengths, stream, timings)

DEPTHS = (1, 2, 4)
SEED = 0
TOL = 1e-5


def pipe_fwd(lib, op, xB, att, depth=1, out=None):
    """The packed-RGCN forward over ``op`` (a ``PackedRgcnSpmm``) with the
    message walk's loads ``depth`` items ahead (1: ``packed_rgcn_fwd``
    itself), into ``out`` (made if None); two launches, each counted.
    ``lib`` is ``probes/rgcn_ablate.py``'s ``load()``."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    csr, send = op.fwd, op.send
    R, B = att.shape
    C = xB.shape[1] // B
    if out is None:
        out = torch.empty(csr.num_rows, C, device=xB.device)
    # scratch: each edge's message, in receiver-major order
    msg = torch.empty(csr.num_edges, C, device=xB.device)
    rc = lib.packed_rgcn_pipe_fwd(
        csr.row_ptr.data_ptr(), send.csr.row_ptr.data_ptr(),
        send.et.data_ptr(), send.w.data_ptr(), send.pos.data_ptr(),
        xB.data_ptr(), att.data_ptr(), msg.data_ptr(), out.data_ptr(),
        csr.num_rows, send.csr.num_rows, R, B, C, depth, stream())
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_pipe_fwd (depth {depth}, B={B}, "
                           f"C={C}) failed: CUDA error {rc}")
    pipe_fwd.launches += 2
    return out


#: Launches of the probe's forward kernels (two a call).
pipe_fwd.launches = 0


def check(lib, op, xB, att):
    """``(depth 1 bitwise equal to packed_rgcn_fwd, its error relative to
    the plain version, {depth: bitwise equal to depth 1})``."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    got = {depth: pipe_fwd(lib, op, xB, att, depth) for depth in DEPTHS}
    library = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
    plain = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    torch.cuda.synchronize()
    err = float((got[1] - plain).abs().max() / plain.abs().max())
    return (torch.equal(got[1], library), err,
            {depth: torch.equal(out, got[1]) for depth, out in got.items()})


def measure(lib, op, B, C, depths, gen, calls):
    """The forward at ``depths`` at (B, C) on ``op``'s CSRs, on fresh
    random xB and att: checked (:func:`check`; raises where a depth
    differs), then each depth timed. One row a depth."""
    from pytorch_geometric_tpu_torch.bounds import rgcn_bound

    xB = torch.randn(op.num_src_rows, B * C, generator=gen, device="cuda")
    att = torch.randn(op.R, B, generator=gen, device="cuda")
    is_library, err, same = check(lib, op, xB, att)
    if not (is_library and err <= TOL and all(same.values())):
        raise AssertionError(f"({B}, {C}): depth 1 bitwise the library's "
                             f"{is_library}, against the plain version "
                             f"{err} (tol {TOL}), depths bitwise equal to "
                             f"depth 1 {same}")
    bound, bound_by = rgcn_bound(op, B, C, backward=False)
    lengths = {"receivers": row_lengths(op.fwd.row_ptr),
               "senders": row_lengths(op.send.csr.row_ptr)}
    rows = []
    for depth in depths:
        out = pipe_fwd(lib, op, xB, att, depth)
        t = timings(lambda: pipe_fwd(lib, op, xB, att, depth, out), calls)
        rows.append({"B": B, "C": C, "depth": depth,
                     "rows": op.fwd.num_rows, "edges": op.E,
                     "row_lengths": lengths, **t,
                     "warm_ns_per_edge": t["warm_us"] * 1e3 / op.E,
                     "flushed_ns_per_edge": t["flushed_us"] * 1e3 / op.E,
                     "rel_err_depth1_vs_plain": err,
                     "bitwise_equal_library": True,
                     "bitwise_equal_depth1": True,
                     "bound_ms": bound, "bound_by": bound_by})
    return rows


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import ORDERS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="30x16,30x2")
    ap.add_argument("--depths", default=",".join(map(str, DEPTHS)))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--order", default=",".join(ORDERS))
    args = ap.parse_args(argv)
    shapes = [tuple(map(int, sh.split("x"))) for sh in args.shapes.split(",")]
    depths = [int(dp) for dp in args.depths.split(",")]
    orders = args.order.split(",")
    bad = sorted(set(depths) - set(DEPTHS)) + sorted(set(orders)
                                                     - set(ORDERS))
    if bad:
        ap.error(f"unknown depths or orders {bad}; known: {DEPTHS}, "
                 f"{ORDERS}")
    if not require_card("rgcn_pipe_probe"):
        return 1
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        mutag_graph, rgcn_hub_operator)
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from probes.rgcn_ablate import SOURCE, load

    smi = card()
    emit(build_line("rgcn_pipe_probe", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for order in orders:
        ds, graph = mutag_graph("cuda", order)
        op = rgcn_fused_ops(graph, ds.num_relations)[0]
        cases += [("mutag", order, op, B, C) for B, C in shapes]
    cases.append(("hub", None, rgcn_hub_operator("cuda", SEED), 5, 33))
    for name, order, op, B, C in cases:
        for row in measure(lib, op, B, C, depths, gen, args.calls):
            emit({"probe": "rgcn_pipe", "graph": name, "order": order,
                  **row, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
