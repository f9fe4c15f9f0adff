"""Variants of the block-sparse GAT kernels, and the phases of a row, on
one NVIDIA GPU.

    python3 probes/bsr_gat_variants.py [--calls 50] [--variants a,b]

Each variant is ``pytorch_geometric_tpu_torch/csrc/bsr_gat.cu`` with one
choice of its design undone (a text edit of the source, in ``VARIANTS``),
built through ``kernels/_build.py:build_source`` from a copy under the
git-ignored ``pytorch_geometric_tpu_torch/_build/variants/``; each is
timed beside the shipped library and the first design
(``probes/bsr_gat_designs.py``) on the design probe's cases. One JSON line
per case: warm device µs of each forward, row pass and column pass
(median of three CUDA-graph timings of ``--calls`` calls), each variant's
largest error against the plain versions, and the card's name and power
limit; first, one line per variant with nvcc's register report.

Then (``phases``) the shipped forward and column pass with ``clock64``
read at the phases of every row (its start, after the strip pointers,
after the column list, after the per-(entry, head) terms, at the end;
each read waits for the value the phase produced), RCM-PubMed (8, 8) and
(1, 3), dropout 0.6: the median cycles from the start to each, and the
cycles one SM took for all its rows. Exits non-zero without a card.
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

LIBRARY = REPO / "pytorch_geometric_tpu_torch" / "csrc" / "bsr_gat.cu"
#: name -> (what it undoes, [(text of bsr_gat.cu, its replacement)]).
VARIANTS = {
    "no_wave_doubling": (
        "rows of a launch under one wave keep their lanes",
        [("  if (L < 32 && static_cast<long long>(n) * L < wave_threads()) "
          "L *= 2;\n", "")]),
    "pairs_column_pass": (
        "the column pass forms its terms apart from the gather, in shared "
        "memory, at every width",
        [("      const bool fused = ln.cv > 0;",
          "      const bool fused = false;")]),
    "rows4": (
        "four float4 sender rows a lane in flight, not two",
        [("constexpr int rows_of(int V) { return V == 4 ? 2 : 4; }",
          "constexpr int rows_of(int V) { return 4; }")]),
    "fwd_registers_free": (
        "the forward without its cap of 64 registers",
        [("__global__ void __launch_bounds__(kThreads, 4)\nbsr_fwd_kernel(",
          "__global__ void __launch_bounds__(kThreads)\nbsr_fwd_kernel(")]),
    "pairs8": (
        "chunks of 8 (entry, head) pairs a lane, not 16",
        [("constexpr int kPairsPerLane = 16;",
          "constexpr int kPairsPerLane = 8;")]),
    "row_rows4": (
        "four sender rows a lane of the row pass in flight, not two",
        [("constexpr int kRowRows = 2;", "constexpr int kRowRows = 4;")]),
    "lanes_from_8": (
        "at least 8 lanes a row",
        [("int lanes_per_row(int H, int C, int V, int n) {\n  int L = 4;",
          "int lanes_per_row(int H, int C, int V, int n) {\n  int L = 8;")]),
}
#: Text edits that add the phase clocks: (text, replacement); the
#: ``{row}`` of each is the row variable of the kernel edited.
_PHASES = [
    ("namespace {\n\n// One direction",
     "__device__ long long bsr_clock[kClockRows * 5];\n"
     "__device__ unsigned bsr_clock_sm[kClockRows];\n"
     "namespace {\n\n// One direction"),
    ("  const Row<L> row;\n  const float* __restrict__ s = a.s;\n",
     "  const Row<L> row;\n  CLOCK(i, 0, 0);\n"
     "  const float* __restrict__ s = a.s;\n"),
    ("    Cursor cur = cursor_of(mask, i);\n",
     "    Cursor cur = cursor_of(mask, i);\n    CLOCK(i, 1, cur.count);\n"),
    ("      const int ne = decode_chunk<L>(mask, cur, cols, chunk, row);\n",
     "      const int ne = decode_chunk<L>(mask, cur, cols, chunk, row);\n"
     "      CLOCK(i, 2, ne);\n"),
    ("      // the chunk's sums, NB entries a lane with their rows' loads",
     "      CLOCK(i, 3, wgt[0]);\n"
     "      // the chunk's sums, NB entries a lane with their rows' loads"),
    ("    if (c0 == 0) {\n      for (int hd = row.lane; hd < H; hd += L) {\n"
     "        const float m = m_h[hd];",
     "    CLOCK(i, 4, acc[0]);\n"
     "    if (c0 == 0) {\n      for (int hd = row.lane; hd < H; hd += L) {\n"
     "        const float m = m_h[hd];"),
    ("  const int cv = lanes.cv;\n  const bool owner = q % cv == 0;",
     "  const int cv = lanes.cv;\n  CLOCK(j, 0, 0);\n"
     "  const bool owner = q % cv == 0;"),
    ("  Cursor cur = cursor_of(mask_t, j);\n  for (;;) {\n"
     "    const int ne = decode_chunk<L>(mask_t, cur, cols, chunk, row);\n",
     "  Cursor cur = cursor_of(mask_t, j);\n  CLOCK(j, 1, cur.count);\n"
     "  for (;;) {\n"
     "    const int ne = decode_chunk<L>(mask_t, cur, cols, chunk, row);\n"
     "    CLOCK(j, 2, ne);\n"),
    ("  // the entry groups' sums meet\n  ds_acc",
     "  CLOCK(j, 3, acc[0]);\n  // the entry groups' sums meet\n  ds_acc"),
    ("    if (owner) ds[jrow * H + hc] = ds_acc;\n  }\n}",
     "    if (owner) ds[jrow * H + hc] = ds_acc;\n  }\n"
     "  CLOCK(j, 4, ds_acc);\n}"),
]
#: The entry point that copies the clocks out, after bsr_gat_chunk.
_CLOCK_READ = (
    "// Entries of one column-list chunk",
    "extern \"C\" int bsr_clock_read(void* clk, void* sm) {\n"
    "  cudaMemcpyFromSymbol(clk, bsr_clock, sizeof(bsr_clock));\n"
    "  cudaMemcpyFromSymbol(sm, bsr_clock_sm, sizeof(bsr_clock_sm));\n"
    "  return static_cast<int>(cudaGetLastError());\n}\n\n"
    "// Entries of one column-list chunk")
#: Rows whose phases are kept.
CLOCK_ROWS = 24576
_CLOCK_HEAD = """
constexpr int kClockRows = %d;
// the clock at phase k of row r, by its lane 0, once the value `dep`
// that the phase produced is there (and the SM's id at phase 0)
#define CLOCK(r, k, dep)                                                   \\
  do {                                                                     \\
    if ((threadIdx.x & (L - 1)) == 0 && (r) < kClockRows) {                \\
      asm volatile("" ::"f"(static_cast<float>(dep)));                     \\
      const long long now = clock64();                                     \\
      if (k == 0) {                                                        \\
        unsigned sm;                                                       \\
        asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));                 \\
        bsr_clock_sm[r] = sm;                                              \\
      }                                                                    \\
      bsr_clock[(r) * 5 + (k)] = now;                                      \\
    }                                                                      \\
  } while (0)
""" % CLOCK_ROWS
_P = ctypes.c_void_p


def variant_source(edits, head=""):
    """bsr_gat.cu with ``edits`` made; each text must occur once."""
    return common.variant_source(LIBRARY, edits, head)


def build_variants(variants):
    """{name: (loaded library, nvcc's register lines)} of each variant
    (name -> (edits, extra signatures, head)), each built from its own
    copy, one nvcc per copy, all started together."""
    from pytorch_geometric_tpu_torch.kernels import _build

    return common.build_variants(LIBRARY, variants,
                                 _build.SIGNATURES["bsr_gat"])


def probe_variants(built, names, calls, smi):
    from probes import bsr_gat_designs as bd

    libs = {}
    for name in names:
        libs[name], regs = built[name]
        emit({"probe": "bsr_gat_variants", "variant": name,
              "undoes": VARIANTS[name][0], "registers": regs, "card": smi})
    first = bd.load()
    gen = torch.Generator(device="cuda").manual_seed(bd.SEED)
    for graph, mask in bd.masks().items():
        for name, H, C, rate in bd.CASES:
            if name != graph:
                continue
            inputs, _ = bd.compare(first, mask, H, C, rate, gen)
            d, s, h, lse, out, big_d, g, seed = inputs
            line = {"probe": "bsr_gat_variants", "graph": graph, "H": H,
                    "C": C, "rate": rate, "us": {}, "rel_err": {}}
            kernel_args = {"fwd": (bd.fwd, (d, s, h, seed)),
                           "bwd_row": (bd.bwd_row,
                                       (d, s, h, lse, out, g, seed)),
                           "bwd_col": (bd.bwd_col,
                                       (d, s, h, lse, big_d, g, seed))}
            for design in ("first", "shipped"):
                for kernel, (fn, args) in kernel_args.items():
                    outs = fn(first, design, mask, *args, rate)
                    line["us"][f"{design}_{kernel}"] = timings(
                        lambda: fn(first, design, mask, *args, rate,
                                   outs=outs), calls, runs=3)["warm_us"]
            for vname, lib in libs.items():
                for kernel, entry, blocks, args in (
                        ("fwd", lib.bsr_gat_fwd, mask.row,
                         [d, s, h, seed, torch.empty_like(h),
                          torch.empty_like(d)]),
                        ("bwd_row", lib.bsr_gat_bwd_row, mask.row,
                         [d, s, h, lse, out, g, seed, torch.empty_like(d),
                          torch.empty_like(d)]),
                        ("bwd_col", lib.bsr_gat_bwd_col, mask.col,
                         [d, s, h, lse, big_d, g, seed,
                          torch.empty_like(d), torch.empty_like(h)])):
                    def call():
                        bd._call(entry, blocks, mask, args, H, C, rate, 0.2)
                    call()
                    want = kernel_args[kernel][0](
                        first, "shipped", mask, *args[:-2], rate)
                    torch.cuda.synchronize()
                    line["rel_err"][f"{vname}_{kernel}"] = bd._rel(
                        args[-2:], want)
                    line["us"][f"{vname}_{kernel}"] = timings(
                        call, calls, runs=3)["warm_us"]
            emit({**line, "calls": calls, "card": smi})


#: The phase clocks as a variant: edits, extra signatures, head.
PHASES = (_PHASES + [_CLOCK_READ],
          {"bsr_clock_read": (ctypes.c_int, [_P, _P])}, _CLOCK_HEAD)


def probe_phases(lib, regs, smi):
    from probes import bsr_gat_designs as bd
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    mask = bd.masks()["pubmed_rcm"]
    n = mask.n
    gen = torch.Generator(device="cuda").manual_seed(bd.SEED)
    for H, C in ((8, 8), (1, 3)):
        d, s = (torch.randn(n, H, generator=gen, device="cuda")
                for _ in range(2))
        h, g = (torch.randn(n, H * C, generator=gen, device="cuda")
                for _ in range(2))
        seed = torch.tensor([bd.GAT_SEED], dtype=torch.int32, device="cuda")
        out, lse = bg.bsr_gat_fwd_plain(mask, d, s, h, seed, 0.6)
        _, big_d = bg.bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g,
                                            seed, 0.6)
        for kernel in ("fwd", "bwd_col"):
            for _ in range(3):
                if kernel == "fwd":
                    bd._call(lib.bsr_gat_fwd, mask.row, mask,
                             (d, s, h, seed, torch.empty_like(h),
                              torch.empty_like(d)), H, C, 0.6, 0.2)
                else:
                    bd._call(lib.bsr_gat_bwd_col, mask.col, mask,
                             (d, s, h, lse, big_d, g, seed,
                              torch.empty_like(d), torch.empty_like(h)),
                             H, C, 0.6, 0.2)
            torch.cuda.synchronize()
            clk = np.zeros(CLOCK_ROWS * 5, np.int64)
            sm = np.zeros(CLOCK_ROWS, np.uint32)
            lib.bsr_clock_read(clk.ctypes.data, sm.ctypes.data)
            clk = clk.reshape(-1, 5)
            rel = clk[:, 1:] - clk[:, :1]
            one = sm == sm[0]
            emit({"probe": "bsr_gat_variants", "phases": kernel, "H": H,
                  "C": C, "rate": 0.6, "graph": "pubmed_rcm",
                  "median_cycles_to_strip_ptr_list_terms_end":
                      [statistics.median(rel[:, k]) for k in range(4)],
                  "rows_on_one_sm": int(one.sum()),
                  "cycles_of_one_sm": int((clk[one, 4].max()
                                           - clk[one, 0].min())),
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
    if not require_card("bsr_gat_variants"):
        return 1
    smi = card()
    built = build_variants({**{name: (VARIANTS[name][1], {}, "")
                               for name in names}, "phases": PHASES})
    probe_variants(built, names, args.calls, smi)
    probe_phases(*built["phases"], smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
