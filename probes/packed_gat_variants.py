"""Variants of the packed-GAT forward and backward, and the phases of a
backward row, on one NVIDIA GPU.

    python3 probes/packed_gat_variants.py [--calls 50] [--variants a,b]

Each variant is ``pytorch_geometric_tpu_torch/csrc/packed_gat.cu`` with
one choice of its forward's or backward's design undone (a text edit of
the source, in ``VARIANTS``), built through
``kernels/_build.py:build_source`` from a copy under the git-ignored
``pytorch_geometric_tpu_torch/_build/variants/``
(``probes/common.py:build_variants``); each is timed beside the shipped
library and the first design (``probes/packed_gat_designs.py``) on the
design probe's cases at dropout 0.6. One JSON line per case: warm device
µs of each forward (``fwd_us``) and two-walk backward call (``us``)
(median of three CUDA-graph timings of ``--calls`` calls), each one's
largest error against its plain version, and the card's name and power
limit; first, one line per variant with nvcc's register report.

Then (``phases``) the shipped backward with ``clock64`` read at the
phases of every row (its start, after its ``row_ptr`` pair, after the
walk over its edges, at the end; each read waits for the value the phase
produced) and the walk's steps (``kEdgeLoads`` edges a lane each), at the
design probe's (8, 8) cases, dropout 0.6, each walk alone: the median
cycles from the start to each phase, and the cycles a step took in the
median row and in the longest. Exits non-zero without a card.
"""

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes import common  # noqa: E402
from probes.common import card, emit, require_card, timings  # noqa: E402

LIBRARY = REPO / "pytorch_geometric_tpu_torch" / "csrc" / "packed_gat.cu"
#: name -> (what it undoes, [(text of packed_gat.cu, its replacement)]).
VARIANTS = {
    "edges4": (
        "four edges a lane in flight, not two (heads of up to 8 channels)",
        [("constexpr int kEdgeLoads = 2;", "constexpr int kEdgeLoads = 4;")]),
    "no_wave_doubling": (
        "rows of a launch under one wave keep their lanes",
        [("  if (L < 32 && static_cast<long long>(n_rows) * L < "
          "wave_threads()) L *= 2;\n", "")]),
    "fwd_serial_sums": (
        "the forward's den and each of its channels summed in a tree of "
        "its own, one tree after another, not a level at a time for all",
        [("  row.sum_groups(acc, C, den, r0, H, R);\n",
          "#pragma unroll\n"
          "  for (int k = 0; k <= KC; ++k) {\n"
          "    float& v = k < KC ? acc[k] : den;\n"
          "    if (k < C || k == KC) {\n"
          "      for (int s = 1; s < R; s <<= 1) {\n"
          "        const float o = __shfl_down_sync(row.mask, v, s * H, L);\n"
          "        if ((r0 & (2 * s - 1)) == 0 && r0 + s < R) v += o;\n"
          "      }\n"
          "    }\n"
          "  }\n")]),
    "fwd_doubled_lanes": (
        "the forward's lanes doubled wherever the launch fills less than "
        "one wave (the backward's rule), not only where a step of the walk "
        "takes fewer than 8 edges",
        [("  if (L < 32 && step < 8 &&\n", "  if (L < 32 && step > 0 &&\n")]),
}
#: Rows whose phases are kept (RCM-PubMed's padded count).
CLOCK_ROWS = 24576
#: Text edits that add the phase clocks to gat_bwd_kernel.
_PHASES = [
    ("  if (r >= a.n_rows) return;\n",
     "  if (r >= a.n_rows) return;\n  CLOCK(r, 0, 0);\n"),
    ("  const int e1 = __ldg(a.row_ptr + r + 1);\n",
     "  const int e1 = __ldg(a.row_ptr + r + 1);\n  CLOCK(r, 1, e1);\n"),
    ("  // the entry groups' sums meet (the only shuffles: the dot is one\n",
     "  CLOCK(r, 2, dsum);\n"
     "  // the entry groups' sums meet (the only shuffles: the dot is one\n"),
    ("    a.out_h[rh] = dsum;\n  }\n}",
     "    a.out_h[rh] = dsum;\n  }\n  CLOCK(r, 3, dsum);\n"
     "  if (row.lane == 0 && r < kClockRows) {\n"
     "    gat_clock[r * 5 + 4] = (e1 - e0 + R * NB - 1) / (R * NB);\n"
     "  }\n}"),
]
_CLOCK_HEAD = """
constexpr int kClockRows = %d;
// per row: the clock at phases 0-3 and the walk's steps
__device__ long long gat_clock[kClockRows * 5];
// the clock at phase k of row r, by its lane 0, once the value `dep`
// that the phase produced is there
#define CLOCK(r, k, dep)                                                   \\
  do {                                                                     \\
    if ((threadIdx.x & (L - 1)) == 0 && (r) < kClockRows) {                \\
      asm volatile("" ::"f"(static_cast<float>(dep)));                     \\
      gat_clock[(r) * 5 + (k)] = clock64();                                \\
    }                                                                      \\
  } while (0)
extern "C" int gat_clock_read(void* clk) {
  cudaMemcpyFromSymbol(clk, gat_clock, sizeof(gat_clock));
  return static_cast<int>(cudaGetLastError());
}
""" % CLOCK_ROWS
#: The phase clocks as a variant: edits, extra signatures, head.
PHASES = (_PHASES, {"gat_clock_read": (ctypes.c_int, [ctypes.c_void_p])},
          _CLOCK_HEAD)


def variant_source(edits, head=""):
    """packed_gat.cu with ``edits`` made; each text must occur once."""
    return common.variant_source(LIBRARY, edits, head)


def probe_variants(built, names, calls, smi):
    from probes import packed_gat_designs as pd
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    for name in names:
        emit({"probe": "packed_gat_variants", "variant": name,
              "undoes": VARIANTS[name][0], "registers": built[name][1],
              "card": smi})
    first = pd.load()
    gen = torch.Generator(device="cuda").manual_seed(pd.SEED)
    for graph, op in pd.ops().items():
        for name, H, C, rate in pd.CASES:
            if name != graph or rate == 0.0:
                continue
            data, _ = pd.compare(first, op, H, C, rate, gen)
            d, s, h, m, seed, g = data
            plain = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g,
                                            rate, op.slope)
            line = {"probe": "packed_gat_variants", "graph": graph, "H": H,
                    "C": C, "rate": rate, "us": {}, "rel_err": {},
                    "fwd_us": {}, "fwd_rel_err": {}}
            plain_fwd = pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed,
                                                rate, op.slope)
            fwds = {design: pd.fwd_entry(first, design)
                    for design in pd.DESIGNS}
            fwds.update((vname, built[vname][0].packed_gat_fwd)
                        for vname in names)
            for key, fn in fwds.items():
                out = pd.fwd(fn, op, data, rate)
                torch.cuda.synchronize()
                line["fwd_rel_err"][key] = pd._rel((out,), (plain_fwd,))
                line["fwd_us"][key] = timings(
                    lambda: pd.fwd(fn, op, data, rate, out), calls,
                    runs=3)["warm_us"]
            fns = {design: pd.entry(first, design)
                   for design in pd.DESIGNS}
            fns.update((vname, built[vname][0].packed_gat_bwd)
                       for vname in names)
            for key, fn in fns.items():
                outs = tuple(pd.bwd_walk(fn, op, data, rate, walk)
                             for walk in (0, 1))
                torch.cuda.synchronize()
                line["rel_err"][key] = pd._rel(outs[0] + outs[1], plain)
                line["us"][key] = timings(
                    lambda: pd.bwd(fn, op, data, rate, outs), calls,
                    runs=3)["warm_us"]
            emit({**line, "calls": calls, "card": smi})


def probe_phases(lib, regs, smi):
    from probes import packed_gat_designs as pd

    gen = torch.Generator(device="cuda").manual_seed(pd.SEED)
    for graph, op in pd.ops().items():
        H, C = 8, 8
        data = pd.inputs(op.n, H, C, gen)
        for walk in (0, 1):
            for _ in range(3):
                pd.bwd_walk(lib.packed_gat_bwd, op, data, 0.6, walk)
            torch.cuda.synchronize()
            clk = np.zeros(CLOCK_ROWS * 5, np.int64)
            lib.gat_clock_read(clk.ctypes.data)
            rows = min(op.n, CLOCK_ROWS)
            clk = clk.reshape(-1, 5)[:rows]
            rel = clk[:, 1:4] - clk[:, :1]
            steps = np.maximum(clk[:, 4], 1)
            per_step = (clk[:, 3] - clk[:, 1]) / steps
            longest = int(np.argmax(clk[:, 4]))
            median_row = int(np.argsort(clk[:, 4])[rows // 2])
            emit({"probe": "packed_gat_variants", "phases": graph,
                  "walk": walk, "H": H, "C": C, "rate": 0.6,
                  "median_cycles_to_row_ptr_walk_end":
                      [statistics.median(rel[:, k]) for k in range(3)],
                  "median_steps": float(np.median(clk[:, 4])),
                  "cycles_per_step_median_row": float(per_step[median_row]),
                  "longest_row_steps": int(clk[longest, 4]),
                  "cycles_per_step_longest_row": float(per_step[longest]),
                  "registers": regs, "card": smi})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",") if args.variants else []
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if not require_card("packed_gat_variants"):
        return 1
    from pytorch_geometric_tpu_torch.kernels import _build

    smi = card()
    built = common.build_variants(
        LIBRARY, {**{name: (VARIANTS[name][1], {}, "") for name in names},
                  "phases": PHASES}, _build.SIGNATURES["packed_gat"])
    probe_variants(built, names, args.calls, smi)
    probe_phases(*built["phases"], smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
