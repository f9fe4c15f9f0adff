"""Design probe of the dense-mask GAT forward and backward, on one
NVIDIA GPU.

    python3 probes/flash_gat_designs.py [--calls 50]

Times the two designs of ``flash_gat_fwd``
(``pytorch_geometric_tpu_torch/csrc/flash_gat.cu``) on the same inputs in
one run: ``fwd_first``, the source's first design, a group of 8 lanes per
(row, head) with an online softmax per lane (``flash_fwd_kernel``,
launched at every width by ``first_flash_gat_fwd``), and
``fwd_shipped``, the port's library, a warp per mask row over all heads,
one lane per (entry, head), the softmax chunk by chunk
(``flash_fwd_row_kernel``, where its map takes (H, C)); and the designs
of ``flash_gat_bwd`` (its row pass ``flash_gat_bwd_row``
and column pass ``flash_gat_bwd_col``,
``pytorch_geometric_tpu_torch/csrc/flash_gat.cu``) on the same inputs in
one run, each pass alone and both together, the call the model makes:

- ``first``: the source's first design, a group of 8 lanes per (row,
  head) walking the row's mask words itself (``flash_bwd_row_heads_kernel``,
  ``flash_bwd_col_heads_kernel``, launched at every width by
  ``probes/flash_gat_designs.cu``);
- ``shipped``: the port's library, a warp per mask row over all heads,
  the row's words read once and decoded into a column list, one lane per
  (entry, head), whole-row gathers (where its map takes (H, C); the first
  design elsewhere);
- ``lanes<L>``: the library's sub-warp design at L = 8 and 16 lanes a row
  (the library takes 32), at the one-head widths;
- ``channels``: the library's row pass, and the column pass with the
  block-sparse column pass's lane map (the channels of a row over the
  lanes, the dot a shuffle over a head's lanes), which the library's map
  was measured against.

Cases: Cora's mask (``nn/conv/gat_dense_adj`` of
``datasets/graphs.py:cora_graph``: 3072 nodes, ~13.6k entries) at conv1's
(H, C) = (8, 8) and conv2's (1, 7), attention dropout 0 and 0.6; the
half-full mask of 2048 nodes and the operator's cap, 8192 nodes at
PubMed's degree (``datasets/graphs.py:flash_synthetic_masks``), at (8, 8),
dropout 0.6. The backward's inputs (``lse``, ``out``) come from the plain
forward (``ops/flash_gat.py``).

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), then one per case: device
µs of each design and pass with the L2 warm and flushed (median of five
CUDA-graph timings of ``--calls`` calls, and their spread,
``probes/common.py:timings``), the bound (``bounds.py:flash_gat_bound``),
the largest error of each design against the plain version and of the
first against the shipped one (relative to the largest magnitude;
``first_vs_shipped_D``: the row pass's D alone, which both designs sum in
one order; ``fwd_*``: the forward's out and lse), whether two launches
of the shipped forward are bitwise equal, and the card's name and power
limit. Exits non-zero without a card.
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

SOURCE = REPO / "probes" / "flash_gat_designs.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_FWD = (_I, [_P] * 7 + [_I] * 4 + [_U, _F, _F, _P])
_PASS = (_I, [_P] * 10 + [_I] * 4 + [_U, _F, _F, _P])
_LANES = (_I, [_P] * 10 + [_I] * 4 + [_U, _F, _F, _I, _P])
SIGNATURES = {"first_flash_gat_fwd": _FWD,
              "first_flash_gat_bwd_row": _PASS,
              "first_flash_gat_bwd_col": _PASS,
              "lanes_flash_gat_bwd_row": _LANES,
              "lanes_flash_gat_bwd_col": _LANES,
              "channels_flash_gat_bwd_col": _LANES}
DESIGNS = ("first", "shipped", "channels")
#: Lanes a row of the sub-warp design timed beside the library's 32 at
#: one head.
LANES = (8, 16)
#: (mask, H, C, dropout rate) of each case.
CASES = (("cora", 8, 8, 0.0), ("cora", 8, 8, 0.6), ("cora", 1, 7, 0.0),
         ("cora", 1, 7, 0.6), ("half2048", 8, 8, 0.6),
         ("cap8192", 8, 8, 0.6))
SEED = 0
GAT_SEED = 123457


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def _entries(lib, design):
    """(row pass, column pass) C entry points of a design, each with the
    library's signature: the probe's first design, the port's library, or
    the sub-warp design at L lanes (``lanes<L>``; the lanes bound in)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design == "first":
        return lib.first_flash_gat_bwd_row, lib.first_flash_gat_bwd_col
    shipped = load_library("flash_gat")
    if design == "shipped":
        return shipped.flash_gat_bwd_row, shipped.flash_gat_bwd_col
    if design == "channels":
        return (shipped.flash_gat_bwd_row,
                lambda *a: lib.channels_flash_gat_bwd_col(*a[:-1], 32,
                                                          a[-1]))
    lanes = int(design[len("lanes"):])
    return (lambda *a: lib.lanes_flash_gat_bwd_row(*a[:-1], lanes, a[-1]),
            lambda *a: lib.lanes_flash_gat_bwd_col(*a[:-1], lanes, a[-1]))


def _call(fn, bits, tensors, n, W, H, C, rate, slope, what):
    from pytorch_geometric_tpu_torch.ops.packed_gat import _launch_args

    rc = fn(bits.data_ptr(), *(t.data_ptr() for t in tensors), n, W, H, C,
            *_launch_args(rate, slope,
                          torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"flash_gat_designs {what} failed: CUDA error "
                           f"{rc}")


#: The forward's designs.
FWD_DESIGNS = ("first", "shipped")


def fwd(lib, design, mask, inputs, rate, slope=0.2, outs=None):
    """``(out, lse)`` of one forward design (``first`` or ``shipped``),
    into ``outs`` (made from torch.empty if None)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    d, s, h, _, _, _, seed = inputs
    H = d.shape[1]
    out, lse = outs if outs is not None else (
        torch.empty_like(h), torch.empty_like(d))
    if design not in FWD_DESIGNS:
        raise ValueError(f"unknown forward design {design!r}")
    fn = (lib.first_flash_gat_fwd if design == "first"
          else load_library("flash_gat").flash_gat_fwd)
    _call(fn, mask.bits, (d, s, h, seed, out, lse), mask.n, mask.words, H,
          h.shape[1] // H, rate, slope, f"{design} forward")
    return out, lse


def compare_fwd(lib, adj, mask, inputs, rate):
    """Both forward designs against the plain version and the first
    against the shipped one (out and lse, relative to the largest
    reference magnitude), and whether two launches of the shipped design
    are bitwise equal: ``(errors, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    d, s, h, _, _, _, seed = inputs
    plain = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    got = {design: fwd(lib, design, mask, inputs, rate)
           for design in FWD_DESIGNS}
    again = fwd(lib, "shipped", mask, inputs, rate)
    torch.cuda.synchronize()
    errors = {f"fwd_{design}_vs_plain": _rel(res, plain)
              for design, res in got.items()}
    errors["fwd_first_vs_shipped"] = _rel(got["first"], got["shipped"])
    return errors, all(torch.equal(a, b)
                       for a, b in zip(again, got["shipped"]))


def bwd_row(lib, design, mask, inputs, rate, slope=0.2, outs=None):
    """``(dd, D)`` of one design's row pass, into ``outs`` (made from
    torch.empty if None)."""
    d, s, h, lse, out, g, seed = inputs
    H = d.shape[1]
    dd, big_d = outs if outs is not None else (
        torch.empty_like(d), torch.empty_like(d))
    _call(_entries(lib, design)[0], mask.bits,
          (d, s, h, lse, out, g, seed, dd, big_d), mask.n, mask.words, H,
          h.shape[1] // H, rate, slope, f"{design} row pass")
    return dd, big_d


def bwd_col(lib, design, mask, inputs, big_d, rate, slope=0.2, outs=None):
    """``(ds, dh)`` of one design's column pass over the row pass's
    ``big_d``, into ``outs``."""
    d, s, h, lse, _, g, seed = inputs
    H = d.shape[1]
    ds, dh = outs if outs is not None else (
        torch.empty_like(d), torch.empty_like(h))
    _call(_entries(lib, design)[1], mask.bits_t,
          (d, s, h, lse, big_d, g, seed, ds, dh), mask.n, mask.words, H,
          h.shape[1] // H, rate, slope, f"{design} column pass")
    return ds, dh


def bwd(lib, design, mask, inputs, rate, outs=None):
    """``(dd, ds, dh)``: both passes of a design, into ``outs`` (a pair of
    :func:`bwd_row` and :func:`bwd_col` outputs)."""
    outs = outs or (None, None)
    dd, big_d = bwd_row(lib, design, mask, inputs, rate, outs=outs[0])
    return (dd,) + bwd_col(lib, design, mask, inputs, big_d, rate,
                           outs=outs[1])


def _rel(got, want):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def designs(H, C):
    """The designs timed at (H, C): ``DESIGNS``, and at one head the
    sub-warp design at each of ``LANES``."""
    return DESIGNS + (tuple(f"lanes{L}" for L in LANES) if H == 1 else ())


def compare(lib, adj, mask, H, C, rate, gen):
    """Every design's backward on random inputs at (H, C) over the dense
    mask ``adj`` (its ``BitMask`` ``mask``), against the plain version and
    the first design against the shipped one: ``(inputs, errors)``,
    errors relative to the largest reference magnitude."""
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    n = mask.n
    d, s = (torch.randn(n, H, generator=gen, device="cuda")
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device="cuda")
            for _ in range(2))
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device="cuda")
    out, lse = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    inputs = (d, s, h, lse, out, g, seed)
    plain = fg.flash_gat_bwd_plain(adj, d, s, h, lse, out, g, seed, rate)
    got, big_d = {}, {}
    for design in designs(H, C):
        dd, big_d[design] = bwd_row(lib, design, mask, inputs, rate)
        got[design] = (dd,) + bwd_col(lib, design, mask, inputs,
                                      big_d[design], rate)
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel(res, plain)
              for design, res in got.items()}
    errors["first_vs_shipped"] = _rel(got["first"], got["shipped"])
    errors["first_vs_shipped_D"] = _rel((big_d["first"],),
                                        (big_d["shipped"],))
    return inputs, errors


def masks():
    """{name: (dense mask, BitMask)} of the probe's masks, on the card."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, flash_synthetic_masks)
    from pytorch_geometric_tpu_torch.nn.conv import gat_dense_adj
    from pytorch_geometric_tpu_torch.ops.flash_gat import BitMask

    adjs = {"cora": gat_dense_adj(cora_graph("cuda")[1])}
    for name, adj in flash_synthetic_masks(SEED):
        adjs[name] = torch.from_numpy(adj).to("cuda")
    return {name: (adj, BitMask(adj)) for name, adj in adjs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--cases", default=",".join(sorted({c[0]
                                                        for c in CASES})))
    args = ap.parse_args(argv)
    names = args.cases.split(",")
    unknown = sorted(set(names) - {c[0] for c in CASES})
    if unknown:
        ap.error(f"unknown cases {unknown}; known: "
                 f"{sorted({c[0] for c in CASES})}")
    if not require_card("flash_gat_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import flash_gat_bound

    smi = card()
    emit(build_line("flash_gat_designs", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for graph, (adj, mask) in masks().items():
        for name, H, C, rate in CASES:
            if name != graph or name not in names:
                continue
            inputs, errors = compare(lib, adj, mask, H, C, rate, gen)
            fwd_errors, fwd_repeat = compare_fwd(lib, adj, mask, inputs,
                                                 rate)
            valid = int(adj.sum())
            line = {"probe": "flash_gat_designs", "graph": graph,
                    "rows": mask.n, "valid_entries": valid, "H": H, "C": C,
                    "rate": rate, "errors": {**fwd_errors, **errors},
                    "fwd_bitwise_repeat": fwd_repeat}
            for design in FWD_DESIGNS:
                outs = fwd(lib, design, mask, inputs, rate)
                line[f"fwd_{design}"] = timings(
                    lambda: fwd(lib, design, mask, inputs, rate, outs=outs),
                    args.calls)
            line["fwd_bound_ms"], line["fwd_bound_by"] = flash_gat_bound(
                mask.n, valid, H, C, False)
            for design in designs(H, C):
                dd, big_d = bwd_row(lib, design, mask, inputs, rate)
                outs = ((dd, big_d),
                        bwd_col(lib, design, mask, inputs, big_d, rate))
                line[f"{design}_row"] = timings(
                    lambda: bwd_row(lib, design, mask, inputs, rate,
                                    outs=outs[0]), args.calls)
                line[f"{design}_col"] = timings(
                    lambda: bwd_col(lib, design, mask, inputs, big_d, rate,
                                    outs=outs[1]), args.calls)
                line[design] = timings(
                    lambda: bwd(lib, design, mask, inputs, rate, outs),
                    args.calls)
            line["bound_ms"], line["bound_by"] = flash_gat_bound(
                mask.n, valid, H, C, True)
            emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
