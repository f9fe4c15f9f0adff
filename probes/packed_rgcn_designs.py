"""Design probe of the packed-RGCN backward, on one NVIDIA GPU.

    python3 probes/packed_rgcn_designs.py [--calls 50] [--cases a,b]

Times the designs of ``packed_rgcn_bwd``
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
``dae`` scratch back, the scratch's bytes (written by the walk and read
by the reduction) and their time at the card's memory rate, the bound
(``bounds.py:rgcn_bound``, which does not count the scratch), whether
the designs agree bit for bit and their largest error against the plain
version, the row lengths of the sender-major CSR, and the card's name and
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
    build_line, card, emit, require_card, row_lengths, stream, timings)

SOURCE = REPO / "probes" / "packed_rgcn_designs.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
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
        agree = compare(lib, op, xB, att, g, designs)
        dae_bytes = 2 * op.E * B * 4
        line = {"probe": "packed_rgcn_designs", "case": case, "B": B,
                "C": C, "R": op.R, "rows": op.bwd.num_rows, "edges": op.E,
                "row_lengths": row_lengths(op.bwd.row_ptr),
                "rel_err_vs_plain": {k: v[0] for k, v in agree.items()},
                "bitwise_vs_shipped": {k: v[1] for k, v in agree.items()},
                "dae_scratch_bytes": dae_bytes,
                "dae_scratch_at_memory_rate_us":
                    dae_bytes / HBM_BYTES_PER_S * 1e6}
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
