"""Prefetch depths of the packed-RGCN forward kernel, on one NVIDIA GPU.

    python3 probes/rgcn_pipe_probe.py [--shapes 30x16,30x2]
                                      [--depths 1,2,4] [--calls 50]
                                      [--order rcm,as_trained]

Counterpart of ``tools/rgcn_pipe_probe.py``, which timed the TPU forward
against a variant that built the next tile's one-hots in double-buffered
scratch while the current tile's products ran (its ``pipe``, in the
``early`` and ``mid`` orders). The Hopper kernel builds no one-hots; its
serial chain is the dependent loads of each edge: ``col[e]``, ``et[e]``
and ``w[e]``, then the edge's ``att`` and ``xB`` values, then the
multiply-adds. ``--depths`` stands in place of ``--orders``: depth 1 is
the first design of the forward, ``rgcn_fwd_kernel`` of
``csrc/packed_rgcn.cu`` (a warp per receiver row gathering each sender's
``xB`` row per edge, which the library's two-launch forward replaced);
depths 2 and 4 run ``rgcn_fwd_ahead_kernel``
(``probes/packed_rgcn_ablate.cu``), that walk with the indices of the
next D edges and the ``att`` and ``xB`` values of edge e + 1 requested
before edge e's multiply-adds, which keep their order, so every depth
gives the same bits.

The graph is MUTAG-RDF at full size in each ``--order``
(``pytorch_geometric_tpu_torch/datasets/graphs.py``), the edges and
weights of the conv1 operator that ``train_rgcn`` builds (embed mode,
24,576 source rows); each ``--shapes``
entry BxC is one xB (24,576, B*C) and att (46, B). Before timing, each
depth's output is checked bitwise against depth 1, and depth 1 within
1e-5 (relative to the largest magnitude) of ``packed_rgcn_fwd_plain``, as
the tool asserts its parity before timing. One JSON line per order,
shape and depth: device µs per call and ns per edge with the L2 warm and
flushed (median of five CUDA-graph timings of ``--calls`` calls, and
their spread), the bound, the walked CSR's row lengths, and the card's
name and power limit. Exits non-zero without a card.
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
    """The first design's forward over ``op``'s receiver-major CSR with
    loads ``depth`` edges ahead (1: ``rgcn_fwd_kernel`` itself), into
    ``out`` (made if None). ``lib`` is ``probes/rgcn_ablate.py``'s
    ``load()``."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    csr = op.fwd
    B = att.shape[1]
    C = xB.shape[1] // B
    if out is None:
        out = torch.empty(csr.num_rows, C, device=xB.device)
    rc = lib.packed_rgcn_pipe_fwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), op.fwd_et.data_ptr(),
        op.fwd_w.data_ptr(), xB.data_ptr(), att.data_ptr(), out.data_ptr(),
        csr.num_rows, B, C, depth, stream())
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_pipe_fwd (depth {depth}, B={B}, "
                           f"C={C}) failed: CUDA error {rc}")
    pipe_fwd.launches += 1
    return out


#: Launches of the probe's forward kernel.
pipe_fwd.launches = 0


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
    from pytorch_geometric_tpu_torch.bounds import rgcn_bound
    from pytorch_geometric_tpu_torch.datasets.graphs import mutag_graph
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import (
        packed_rgcn_fwd_plain)
    from probes.rgcn_ablate import SOURCE, load

    smi = card()
    emit(build_line("rgcn_pipe_probe", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for order in orders:
        ds, graph = mutag_graph("cuda", order)
        op = rgcn_fused_ops(graph, ds.num_relations)[0]
        for B, C in shapes:
            xB = torch.randn(op.num_src_rows, B * C, generator=gen,
                             device="cuda")
            att = torch.randn(op.R, B, generator=gen, device="cuda")
            ref = pipe_fwd(lib, op, xB, att)
            want = packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB,
                                         att)
            torch.cuda.synchronize()
            err = float((ref - want).abs().max() / want.abs().max())
            if err > TOL:
                raise AssertionError(f"depth 1 against the plain version: "
                                     f"{err} > {TOL} ({order}, {B}x{C})")
            for depth in depths:
                out = pipe_fwd(lib, op, xB, att, depth)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"depth {depth} differs from depth "
                                         f"1 ({order}, {B}x{C})")
                t = timings(lambda: pipe_fwd(lib, op, xB, att, depth, out),
                            args.calls)
                bound, bound_by = rgcn_bound(op, B, C, backward=False)
                emit({"probe": "rgcn_pipe", "graph": "mutag", "order": order,
                      "B": B, "C": C, "depth": depth, "rows": op.fwd.num_rows,
                      "edges": op.E, "row_lengths": row_lengths(
                          op.fwd.row_ptr), **t,
                      "warm_ns_per_edge": t["warm_us"] * 1e3 / op.E,
                      "flushed_ns_per_edge": t["flushed_us"] * 1e3 / op.E,
                      "rel_err_depth1_vs_plain": err,
                      "bitwise_equal_depth1": True,
                      "bound_ms": bound, "bound_by": bound_by,
                      "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
