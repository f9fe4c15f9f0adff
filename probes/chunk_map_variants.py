"""Variants of the chunk maps of the CSR SpMM and the segment sum, on one
NVIDIA GPU.

    python3 probes/chunk_map_variants.py [--calls 50] [--variants a,b]

Each variant is a production source with one choice of its chunk map
changed (a text edit, in ``VARIANTS``): ``spmm_*`` edit
``pytorch_geometric_tpu_torch/csrc/spmm_csr.cu``
(``spmm_csr_chunks_kernel``), ``seg_*`` edit ``csrc/segment_sum.cuh``
(``segment_sum_chunks_kernel``) in a copy under a name of its own, which
the variant's copy of ``csrc/sorted_spmm.cu`` includes. Each is built
through ``kernels/_build.py:build_source`` from a copy under the
git-ignored ``pytorch_geometric_tpu_torch/_build/variants/``
(``probes/common.py:build_variants``), and its entry point
(``spmm_csr`` or ``sorted_segment_sum``) is timed beside the shipped
library's on the chunk map's cases of the design probes (``CASES``: the
Cora GCN CSR at F = 1433, 300 and 33 and Spline's first kernel-index CSR
at 1433, fp32 x, forward; DNA's key-value gradients by sender at 1024,
512 and 256 and the RGCN hub operator's C = 33, fp32 messages). One JSON
line per variant with nvcc's register report, then one per case: warm
and L2-flushed device µs of each (``probes/common.py:timings``), whether
each is bitwise equal to the library (every variant keeps the sums'
order), and the card's name and power limit. Exits non-zero without a
card.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes import common  # noqa: E402
from probes.common import card, emit, require_card, stream  # noqa: E402

CSRC = REPO / "pytorch_geometric_tpu_torch" / "csrc"
#: kernel -> (its library's source, the text its edits are made in).
SOURCES = {"spmm": (CSRC / "spmm_csr.cu", CSRC / "spmm_csr.cu"),
           "seg": (CSRC / "sorted_spmm.cu", CSRC / "segment_sum.cuh")}
_NB = "  constexpr int NB = V * K < 8 ? 8 / (V * K) : 1;\n"
_BOUNDS = "__launch_bounds__(kThreads)\nspmm_csr_chunks_kernel("
_EDGES = "constexpr int kEdges = 8;\n"
#: name -> (what it changes, [(text of the kernel's source, replacement)]).
VARIANTS = {
    "spmm_edges4": (
        "NB V K = 16 channels a lane in flight, not 8",
        [(_NB, "  constexpr int NB = V * K < 16 ? 16 / (V * K) : 1;\n")]),
    "spmm_edges8": (
        "NB V K = 32 channels a lane in flight, not 8",
        [(_NB, "  constexpr int NB = V * K < 32 ? 32 / (V * K) : 1;\n")]),
    "spmm_blocks4": (
        "registers capped for 4 blocks of 256 threads an SM",
        [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 4)"))]),
    "seg_edges4": (
        "the loads of 4 messages issued together, not 8",
        [(_EDGES, "constexpr int kEdges = 4;\n")]),
    "seg_edges16": (
        "the loads of 16 messages issued together, not 8",
        [(_EDGES, "constexpr int kEdges = 16;\n")]),
}
#: (kernel, graph, direction, F) of each case, fp32.
CASES = (("spmm", "cora", "fwd", 1433), ("spmm", "spline_k0", "fwd", 1433),
         ("spmm", "cora", "fwd", 300), ("spmm", "cora", "fwd", 33),
         ("seg", "dna", "bwd", 1024), ("seg", "dna", "bwd", 512),
         ("seg", "dna", "bwd", 256), ("seg", "rgcn_hub", "fwd", 33))
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"spmm": {"spmm_csr": (_I, [_P] * 5 + [_I] * 3 + [_P])},
              "seg": {"sorted_segment_sum": (_I, [_P] * 3 + [_I] * 3 + [_P])}}
LIBRARIES = {"spmm": "spmm_csr", "seg": "sorted_spmm"}


def kernel_of(variant: str) -> str:
    return variant.split("_")[0]


def build(names):
    """{variant: (library, nvcc's register lines)}: each variant's copy of
    its library's source, with the edited header beside it where the
    edits are in a header."""
    built = {}
    for kernel, (library, edited) in SOURCES.items():
        mine = {n: VARIANTS[n] for n in names if kernel_of(n) == kernel}
        if not mine:
            continue
        if edited == library:
            built.update(common.build_variants(
                library, {n: (v[1], {}, "") for n, v in mine.items()},
                SIGNATURES[kernel]))
            continue
        for name, (_, edits) in mine.items():
            # the header's copy goes under a name of its own, and the
            # variant's copy of the library includes it
            header = f"{edited.stem}_{name}{edited.suffix}"
            text = common.variant_source(edited, edits)
            out = common.build_variants(
                library, {name: ([(f'#include "{edited.name}"',
                                   f'#include "{header}"')], {}, "")},
                SIGNATURES[kernel], extra_files={header: text})
            built.update(out)
    return built


def run(kernel, lib, inputs, out):
    if kernel == "spmm":
        csr, val, x = inputs
        rc = lib.spmm_csr(csr.row_ptr.data_ptr(), csr.col.data_ptr(),
                          val.data_ptr(), x.data_ptr(), out.data_ptr(),
                          csr.num_rows, x.shape[1], 0, stream())
    else:
        rp, msgs = inputs
        rc = lib.sorted_segment_sum(rp.data_ptr(), msgs.data_ptr(),
                                    out.data_ptr(), rp.shape[0] - 1,
                                    msgs.shape[1], 0, stream())
    if rc != 0:
        raise RuntimeError(f"{kernel} variant failed: CUDA error {rc}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if not require_card("chunk_map_variants"):
        return 1
    from probes import segment_sum_designs as gd
    from probes import spmm_csr_designs as sd
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    smi = card()
    built = build(names)
    for name, (_, regs) in built.items():
        emit({"probe": "chunk_map_variants", "variant": name,
              "changes": VARIANTS[name][0], "ptxas": regs, "card": smi})
    kernels = {kernel_of(n) for n in names}
    cases = [c for c in CASES if c[0] in kernels]
    pairs = sd.csr_pairs({g for k, g, _, _ in cases if k == "spmm"})
    ptrs = gd.row_ptrs([g for k, g, _, _ in cases if k == "seg"])
    gen = torch.Generator(device="cuda").manual_seed(sd.SEED)
    for kernel, graph, direction, f in cases:
        if kernel == "spmm":
            csr, val = pairs[graph][direction]
            inputs = (csr, val, torch.randn(csr.num_cols, f, generator=gen,
                                            device="cuda"))
            rows = csr.num_rows
        else:
            rp = ptrs[graph, direction]
            inputs = (rp, torch.randn(int(rp[-1]), f, generator=gen,
                                      device="cuda"))
            rows = rp.shape[0] - 1
        libs = {"shipped": load_library(LIBRARIES[kernel]),
                **{n: lib for n, (lib, _) in built.items()
                   if kernel_of(n) == kernel}}
        outs = {n: run(kernel, lib, inputs,
                       torch.empty(rows, f, device="cuda"))
                for n, lib in libs.items()}
        torch.cuda.synchronize()
        line = {"probe": "chunk_map_variants", "kernel": kernel,
                "graph": graph, "direction": direction, "F": f,
                "dtype": "fp32",
                "bitwise_vs_shipped": {
                    n: torch.equal(out, outs["shipped"])
                    for n, out in outs.items() if n != "shipped"}}
        for n, lib in libs.items():
            line[n] = common.timings(
                lambda: run(kernel, lib, inputs, outs[n]), args.calls)
        emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
