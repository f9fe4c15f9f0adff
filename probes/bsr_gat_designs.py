"""Design probe of the block-sparse GAT forward, row pass and column
pass, on one NVIDIA GPU.

    python3 probes/bsr_gat_designs.py [--calls 50]

Times the two designs of ``bsr_gat_fwd``, ``bsr_gat_bwd_row`` and
``bsr_gat_bwd_col`` (``pytorch_geometric_tpu_torch/csrc/bsr_gat.cu``) on
the same inputs in one run:

- ``first``: the file's first design, a group of 8 lanes per (row, head)
  pair walking its strip's mask words itself, kept verbatim in
  ``probes/bsr_gat_designs.cu`` (namespace ``first_design``);
- ``shipped``: the kernels of the port's library, one sub-warp per row
  over all heads, the row's mask decoded once into a column list in shared
  memory, whole-row gathers;
- ``staged`` (forward only): the library's row code on a persistent grid
  that copies the next tile of rows' mask into shared memory with
  ``cp.async`` while it runs the current tile (a two-stage ring).

Cases: PubMed after RCM (``datasets/graphs.py:pubmed_graph``, 24,576
rows, ~113.2k entries) at (H, C) = (8, 8) and (1, 3), attention dropout 0
and 0.6; Cora at (8, 8) and (1, 7), dropout 0.6; the hub mask
``hub5003`` and the block-dense ``blocks16384``
(``datasets/graphs.py:bsr_synthetic_masks``) at (8, 8), dropout 0.6; the
default tile (1, 32). The backward's inputs (``lse``, ``out``, ``D``)
come from the plain versions (``ops/bsr_gat.py``).

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), then one per case: device
µs of each design and kernel with the L2 warm and flushed (median of five
CUDA-graph timings of ``--calls`` calls, and their spread,
``probes/common.py:timings``), the bound (``bounds.py:bsr_gat_bound``),
the largest error of each design against the plain versions and of the
first design against the shipped one (relative to the largest
magnitude; ``first_vs_shipped_D``: the row pass's D alone, which both
designs sum in one order), and the card's name and power limit. Exits
non-zero without a card.
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
    build_line, card, emit, require_card, timings)

SOURCE = REPO / "probes" / "bsr_gat_designs.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
SIGNATURES = {
    "first_bsr_gat_fwd": (_I, [_P] * 9 + [_I] * 5 + [_U, _F, _F, _P]),
    "first_bsr_gat_bwd_row": (_I, [_P] * 12 + [_I] * 5 + [_U, _F, _F, _P]),
    "staged_bsr_gat_fwd": (_I, [_P] * 9 + [_I] * 5 + [_U, _F, _F, _P]),
    "first_bsr_gat_bwd_col": (_I, [_P] * 12 + [_I] * 5 + [_U, _F, _F, _P]),
}
DESIGNS = ("first", "shipped", "staged")
#: (graph, H, C, dropout rate) of each case.
CASES = (("pubmed_rcm", 8, 8, 0.0), ("pubmed_rcm", 8, 8, 0.6),
         ("pubmed_rcm", 1, 3, 0.0), ("pubmed_rcm", 1, 3, 0.6),
         ("cora", 8, 8, 0.6), ("cora", 1, 7, 0.6),
         ("hub5003", 8, 8, 0.6), ("blocks16384", 8, 8, 0.6))
SEED = 0
GAT_SEED = 123457


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


#: The kernels of a design, by the suffix of their entry points.
KERNELS = ("fwd", "bwd_row", "bwd_col")


def _entry(lib, design, kernel):
    """The C entry point of ``kernel`` (of ``KERNELS``) of a design:
    the probe's first or staged design, or the port's library."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design != "shipped":
        return getattr(lib, f"{design}_bsr_gat_{kernel}")
    return getattr(load_library("bsr_gat"), f"bsr_gat_{kernel}")


def _call(fn, blocks, mask, tensors, H, C, rate, slope):
    from pytorch_geometric_tpu_torch.ops.packed_gat import _launch_args

    rc = fn(*(t.data_ptr() for t in blocks),
            *(t.data_ptr() for t in tensors), mask.n, mask.ti, mask.tj // 32,
            H, C, *_launch_args(rate, slope,
                                torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"bsr_gat probe launch failed: CUDA error {rc}")


def fwd(lib, design, mask, d, s, h, seed, rate, slope=0.2, outs=None):
    """``(out, lse)`` of one design's forward, into ``outs`` (made from
    torch.empty if None)."""
    H = d.shape[1]
    out, lse = outs if outs is not None else (
        torch.empty_like(h), torch.empty_like(d))
    _call(_entry(lib, design, "fwd"), mask.row, mask,
          (d, s, h, seed, out, lse), H, h.shape[1] // H, rate, slope)
    return out, lse


def bwd_row(lib, design, mask, d, s, h, lse, out, g, seed, rate,
            slope=0.2, outs=None):
    """``(dd, D)`` of one design's row pass, into ``outs``."""
    H = d.shape[1]
    dd, big_d = outs if outs is not None else (
        torch.empty_like(d), torch.empty_like(d))
    _call(_entry(lib, design, "bwd_row"), mask.row, mask,
          (d, s, h, lse, out, g, seed, dd, big_d), H, h.shape[1] // H, rate,
          slope)
    return dd, big_d


def bwd_col(lib, design, mask, d, s, h, lse, big_d, g, seed, rate,
            slope=0.2, outs=None):
    """``(ds, dh)`` of one design's column pass, into ``outs``."""
    H = d.shape[1]
    ds, dh = outs if outs is not None else (
        torch.empty_like(d), torch.empty_like(h))
    _call(_entry(lib, design, "bwd_col"), mask.col, mask,
          (d, s, h, lse, big_d, g, seed, ds, dh), H, h.shape[1] // H, rate,
          slope)
    return ds, dh


def _rel(got, want):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def compare(lib, mask, H, C, rate, gen):
    """Both designs' three kernels on random inputs at (H, C),
    against the plain versions and each other: ``(inputs, errors)``,
    errors relative to the largest reference magnitude."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    n = mask.n
    d, s = (torch.randn(n, H, generator=gen, device="cuda")
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device="cuda")
            for _ in range(2))
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device="cuda")
    plain = {"fwd": bg.bsr_gat_fwd_plain(mask, d, s, h, seed, rate)}
    out, lse = plain["fwd"]
    plain["bwd_row"] = bg.bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g,
                                                seed, rate)
    big_d = plain["bwd_row"][1]
    plain["bwd_col"] = bg.bsr_gat_bwd_col_plain(mask, d, s, h, lse, big_d,
                                                g, seed, rate)
    inputs = (d, s, h, lse, out, big_d, g, seed)
    got = {(design, kernel): call()
           for design, kernel, call in _calls(lib, mask, inputs, rate)}
    torch.cuda.synchronize()
    errors = {}
    for (design, kernel), res in got.items():
        errors[f"{design}_{kernel}_vs_plain"] = _rel(res, plain[kernel])
        if design != "shipped":
            errors[f"{design}_vs_shipped_{kernel}"] = _rel(
                res, got["shipped", kernel])
    # D alone: both designs sum it in one order
    errors["first_vs_shipped_D"] = _rel((got["first", "bwd_row"][1],),
                                        (got["shipped", "bwd_row"][1],))
    return inputs, errors


def _calls(lib, mask, inputs, rate, outs=None):
    """(design, kernel, call) of every design's three kernels (the staged
    design has a forward only) on ``inputs``; with ``outs`` ({(design,
    kernel): outputs}) each call writes into its outputs."""
    d, s, h, lse, out, big_d, g, seed = inputs
    outs = outs or {}
    for design in DESIGNS:
        yield design, "fwd", lambda design=design: fwd(
            lib, design, mask, d, s, h, seed, rate,
            outs=outs.get((design, "fwd")))
        if design != "staged":
            yield design, "bwd_row", lambda design=design: bwd_row(
                lib, design, mask, d, s, h, lse, out, g, seed, rate,
                outs=outs.get((design, "bwd_row")))
            yield design, "bwd_col", lambda design=design: bwd_col(
                lib, design, mask, d, s, h, lse, big_d, g, seed, rate,
                outs=outs.get((design, "bwd_col")))


def masks():
    """{name: BlockMask} of the probe's graphs, on the card."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        bsr_synthetic_masks, cora_graph, pubmed_graph)
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.ops.bsr_gat import BsrFlashGat

    out = {"cora": gat_flash_op(cora_graph("cuda")[1], "bsr").mask,
           "pubmed_rcm": gat_flash_op(pubmed_graph("cuda")[1], "bsr").mask}
    for name, senders, receivers, n, _, _ in bsr_synthetic_masks(SEED):
        out[name] = BsrFlashGat.from_edges(senders, receivers, n,
                                           device="cuda").mask
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not require_card("bsr_gat_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import bsr_gat_bound

    smi = card()
    emit(build_line("bsr_gat_designs", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for graph, mask in masks().items():
        for name, H, C, rate in CASES:
            if name != graph:
                continue
            inputs, errors = compare(lib, mask, H, C, rate, gen)
            line = {"probe": "bsr_gat_designs", "graph": graph,
                    "rows": mask.n, "entries": mask.num_entries, "H": H,
                    "C": C, "rate": rate, "tile": [mask.ti, mask.tj],
                    "errors": errors}
            outs = {(design, kernel): call()
                    for design, kernel, call in _calls(lib, mask, inputs,
                                                       rate)}
            for design, kernel, call in _calls(lib, mask, inputs, rate,
                                               outs):
                line[f"{design}_{kernel}"] = timings(call, args.calls)
            for kernel in KERNELS:
                line[f"{kernel}_bound_ms"], line["bound_by"] = bsr_gat_bound(
                    mask.n, mask.num_entries, H, C, kernel)
            emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
