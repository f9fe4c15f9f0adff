"""Design probe of the packed-RGCN forward and backward, on one NVIDIA
GPU.

    python3 probes/packed_rgcn_designs.py [--calls 50] [--cases a,b]

Times the designs of ``packed_rgcn_fwd``
(``pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu``) on the same inputs
in one run:

- ``fwd_first``: the source's first design, ``rgcn_fwd_kernel``, a warp
  per receiver row of the receiver-major CSR that gathers each sender's
  ``xB`` row per edge (``first_packed_rgcn_fwd`` in
  ``probes/packed_rgcn_designs.cu``);
- ``fwd_shipped``: the port's library, two launches: each edge's message
  from a walk of the sender-major CSR that reads each ``xB`` row once,
  into an (E, C) scratch at the edge's receiver-major position, then the
  receiver-sorted segment sum (``csrc/segment_sum.cuh``), also timed
  alone over the scratch (``fwd_segment_sum``);

and of ``packed_rgcn_bwd``
(``pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu``: the walk over the
sender-major CSR, then the two launches of the ``datt`` reduction) on the
same inputs in one run:

- ``first``: the source's first design of the walk, the lanes tiling
  (basis, channel), the row's edges walked once per 16 bases for ``dxB``
  and once more for ``dae``, each edge's indices and ``g`` row loaded on
  every walk (kept in ``probes/packed_rgcn_designs.cu``, namespace
  ``first_design``);
- ``shipped``: the port's library, one walk a row, one lane per basis,
  the indices of 32 edges loaded at once and handed on by shuffle, their
  ``g`` rows staged in shared memory together, each loaded once for both
  terms;
- ``blocks<m>``: the library's walk with at least m = 1, 3, 4, 5 blocks
  per SM (``__launch_bounds__``, which caps its registers: 255, 80, 64,
  48); the library takes 3 at 16 channels a lane, 4 at 8, 5 below.

Cases: the two operators ``train_rgcn`` builds on MUTAG-RDF at full size
(``datasets/graphs.py:mutag_graph``; ``models/entities.py:rgcn_fused_ops``):
conv1 in embed mode, (B, C) = (30, 16), and conv2, (30, 2); and
``chip_smoke.py``'s hub operator (a sender of 2,500 edges, (5, 33);
``datasets/graphs.py:rgcn_hub_operator``).

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), then one per case: device
µs of each design with the L2 warm and flushed (median of five CUDA-graph
timings of ``--calls`` calls, and their spread,
``probes/common.py:timings``), the datt reduction alone, which reads the
``dae`` scratch back, the forward's segment sum alone, which reads the
message scratch back, each scratch's bytes (written and read back) and
their time at the card's memory rate, the bounds
(``bounds.py:rgcn_bound``, which counts neither scratch), the forward
designs' largest errors against the plain version and against each
other, whether the backward designs agree bit for bit and their largest
error against the plain version, the row lengths of both CSRs, and the
card's name and power limit. Exits non-zero without a card.
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
    build_line, card, emit, require_card, row_lengths, stream, timings)

SOURCE = REPO / "probes" / "packed_rgcn_designs.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "first_packed_rgcn_fwd": (_I, [_P] * 7 + [_I] * 3 + [_P]),
    "first_packed_rgcn_bwd": (_I, [_P] * 13 + [_I] * 5 + [_P]),
    "blocks_packed_rgcn_bwd": (_I, [_P] * 13 + [_I] * 6 + [_P]),
    "packed_rgcn_datt": (_I, [_P] * 4 + [_I] * 3 + [_P]),
}
DESIGNS = ("first", "shipped")
#: Blocks per SM of the library's walk timed beside it.
BLOCKS = (1, 3, 4, 5)
#: (case, B, C) of each case.
CASES = (("conv1", 30, 16), ("conv2", 30, 2), ("hub", 5, 33))
SEED = 0


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def _entry(lib, design):
    """The C entry point of a design with ``packed_rgcn_bwd``'s
    signature: the probe's first design, the port's library, or the
    library's walk with at least m blocks per SM (``blocks<m>``; m bound
    in)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design == "first":
        return lib.first_packed_rgcn_bwd
    if design == "shipped":
        return load_library("packed_rgcn").packed_rgcn_bwd
    blocks = int(design[len("blocks"):])
    return lambda *a: lib.blocks_packed_rgcn_bwd(*a[:-1], blocks, a[-1])


def scratch(op, xB, att):
    """dxB, datt and the scratch dae and partial of one call, from
    torch.empty (every element is written)."""
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import DATT_SPLITS

    R, B = att.shape
    dev = xB.device
    return (torch.empty(op.bwd.num_rows, xB.shape[1], device=dev),
            torch.empty(R, B, device=dev),
            torch.empty(op.E, B, device=dev),
            torch.empty(R, DATT_SPLITS, B, device=dev))


def bwd(lib, design, op, xB, att, g, out=None):
    """``(dxB, datt)`` of one design's backward, into ``out`` (made by
    :func:`scratch` if None)."""
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import DATT_SPLITS

    csr = op.bwd
    R, B = att.shape
    out = scratch(op, xB, att) if out is None else out
    rc = _entry(lib, design)(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), op.bwd_et.data_ptr(),
        op.bwd_w.data_ptr(), op.bwd_pos.data_ptr(), op.rel_ptr.data_ptr(),
        xB.data_ptr(), att.data_ptr(), g.data_ptr(),
        *(t.data_ptr() for t in out), csr.num_rows, R, B,
        xB.shape[1] // B, DATT_SPLITS, stream())
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_designs {design} failed: CUDA "
                           f"error {rc}")
    return out[:2]


def datt(lib, op, out):
    """The datt reduction alone over the dae scratch of ``out`` (a
    :func:`scratch` tuple that a backward has filled)."""
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import DATT_SPLITS

    _, datt_out, dae, partial = out
    R, B = datt_out.shape
    rc = lib.packed_rgcn_datt(op.rel_ptr.data_ptr(), dae.data_ptr(),
                              partial.data_ptr(), datt_out.data_ptr(), R, B,
                              DATT_SPLITS, stream())
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_datt failed: CUDA error {rc}")


def fwd_scratch(op, xB, att):
    """out and the message scratch of one forward, from torch.empty."""
    C = xB.shape[1] // att.shape[1]
    return (torch.empty(op.num_nodes, C, device=xB.device),
            torch.empty(op.E, C, device=xB.device))


def fwd(lib, design, op, xB, att, out=None):
    """``out`` of one design's forward (``first`` or ``shipped``, the
    library's C entry point), into ``out`` (a :func:`fwd_scratch` pair,
    made if None)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    R, B = att.shape
    C = xB.shape[1] // B
    out = fwd_scratch(op, xB, att) if out is None else out
    if design == "first":
        csr = op.fwd
        rc = lib.first_packed_rgcn_fwd(
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), op.fwd_et.data_ptr(),
            op.fwd_w.data_ptr(), xB.data_ptr(), att.data_ptr(),
            out[0].data_ptr(), csr.num_rows, B, C, stream())
    elif design == "shipped":
        send = op.send
        rc = load_library("packed_rgcn").packed_rgcn_fwd(
            op.fwd.row_ptr.data_ptr(), send.csr.row_ptr.data_ptr(),
            send.et.data_ptr(), send.w.data_ptr(), send.pos.data_ptr(),
            xB.data_ptr(), att.data_ptr(), out[1].data_ptr(),
            out[0].data_ptr(), op.fwd.num_rows, send.csr.num_rows, R, B, C,
            stream())
    else:
        raise ValueError(f"unknown forward design {design!r}")
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_designs forward {design} failed: "
                           f"CUDA error {rc}")
    return out[0]


def segment_sum(op, out):
    """The forward's second launch alone: the segment sum over the
    message scratch of ``out`` (a :func:`fwd_scratch` pair that the
    shipped forward has filled)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    res, msg = out
    rc = load_library("sorted_spmm").sorted_segment_sum(
        op.fwd.row_ptr.data_ptr(), msg.data_ptr(), res.data_ptr(),
        op.fwd.num_rows, msg.shape[1], 0, stream())
    if rc != 0:
        raise RuntimeError(f"sorted_segment_sum failed: CUDA error {rc}")


def compare_fwd(lib, op, xB, att):
    """Each forward design against the plain version and the first
    against the shipped one, relative to the largest reference magnitude;
    and whether two launches of the shipped one are bitwise equal:
    ``(errors, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    plain = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB, att)
    got = {design: fwd(lib, design, op, xB, att) for design in DESIGNS}
    again = fwd(lib, "shipped", op, xB, att)
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel((res,), (plain,))
              for design, res in got.items()}
    errors["first_vs_shipped"] = _rel((got["first"],), (got["shipped"],))
    return errors, torch.equal(again, got["shipped"])


def inputs(op, B, C, gen):
    """Random xB (source rows, B*C), att (R, B) and g (nodes, C)."""
    xB = torch.randn(op.num_src_rows, B * C, generator=gen, device="cuda")
    att = torch.randn(op.R, B, generator=gen, device="cuda")
    g = torch.randn(op.num_nodes, C, generator=gen, device="cuda")
    return xB, att, g


def all_designs():
    """Every design the probe times: ``DESIGNS`` and the variants."""
    return DESIGNS + tuple(f"blocks{m}" for m in BLOCKS)


def _rel(got, want):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def compare(lib, op, xB, att, g, designs=DESIGNS):
    """Each design's backward against the plain version (relative to the
    largest reference magnitude) and against the shipped design, bit for
    bit: ``{design: (rel_err, bitwise)}``."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    plain = pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w, xB, att, g)
    got = {design: bwd(lib, design, op, xB, att, g) for design in designs}
    torch.cuda.synchronize()
    return {design: (_rel(res, plain),
                     all(torch.equal(a, b)
                         for a, b in zip(res, got["shipped"])))
            for design, res in got.items()}


def ops():
    """{case: operator} of the probe's cases, on the card."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        mutag_graph, rgcn_hub_operator)
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops

    ds, graph = mutag_graph("cuda")
    conv1, conv2 = rgcn_fused_ops(graph, ds.num_relations)
    return {"conv1": conv1, "conv2": conv2,
            "hub": rgcn_hub_operator("cuda", SEED)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    args = ap.parse_args(argv)
    names = args.cases.split(",")
    unknown = sorted(set(names) - {c[0] for c in CASES})
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {[c[0] for c in CASES]}")
    if not require_card("packed_rgcn_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import rgcn_bound
    from pytorch_geometric_tpu_torch.profiling import HBM_BYTES_PER_S

    smi = card()
    emit(build_line("packed_rgcn_designs", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    designs = all_designs()
    for case, op in ops().items():
        if case not in names:
            continue
        _, B, C = next(c for c in CASES if c[0] == case)
        xB, att, g = inputs(op, B, C, gen)
        fwd_errors, fwd_repeat = compare_fwd(lib, op, xB, att)
        agree = compare(lib, op, xB, att, g, designs)
        dae_bytes = 2 * op.E * B * 4
        msg_bytes = 2 * op.E * C * 4
        line = {"probe": "packed_rgcn_designs", "case": case, "B": B,
                "C": C, "R": op.R, "rows": op.bwd.num_rows, "edges": op.E,
                "row_lengths": row_lengths(op.bwd.row_ptr),
                "receiver_row_lengths": row_lengths(op.fwd.row_ptr),
                "fwd_errors": fwd_errors,
                "fwd_bitwise_repeat": fwd_repeat,
                "rel_err_vs_plain": {k: v[0] for k, v in agree.items()},
                "bitwise_vs_shipped": {k: v[1] for k, v in agree.items()},
                "msg_scratch_bytes": msg_bytes,
                "msg_scratch_at_memory_rate_us":
                    msg_bytes / HBM_BYTES_PER_S * 1e6,
                "dae_scratch_bytes": dae_bytes,
                "dae_scratch_at_memory_rate_us":
                    dae_bytes / HBM_BYTES_PER_S * 1e6}
        for design in DESIGNS:
            out = fwd_scratch(op, xB, att)
            fwd(lib, design, op, xB, att, out)
            line[f"fwd_{design}"] = timings(
                lambda: fwd(lib, design, op, xB, att, out), args.calls)
            if design == "shipped":
                line["fwd_segment_sum"] = timings(
                    lambda: segment_sum(op, out), args.calls)
        line["fwd_bound_ms"], line["fwd_bound_by"] = rgcn_bound(op, B, C,
                                                                False)
        for design in designs:
            out = scratch(op, xB, att)
            bwd(lib, design, op, xB, att, g, out)
            line[design] = timings(
                lambda: bwd(lib, design, op, xB, att, g, out), args.calls)
            if design == "shipped":
                line["datt_reduction"] = timings(
                    lambda: datt(lib, op, out), args.calls)
        line["bound_ms"], line["bound_by"] = rgcn_bound(op, B, C, True)
        emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
