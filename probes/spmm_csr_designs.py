"""Design probe of the CSR SpMM, on one NVIDIA GPU.

    python3 probes/spmm_csr_designs.py [--calls 50] [--cases cora,hub]

Times the designs of ``spmm_csr``
(``pytorch_geometric_tpu_torch/csrc/spmm_csr.cu``) on the same inputs in
one run:

- ``first``: the source's first design, a group of lanes per row walking
  the row's edges one after another (``spmm_csr_kernel``, launched at
  every width by ``first_spmm_csr`` of ``probes/spmm_csr_designs.cu``);
- ``shipped``: the port's library, the row map (``spmm_csr_rows_kernel``:
  L lanes a row, P of them across the channels at V a lane, the row's
  edges spread over the L / P entry groups, the partial sums met in a
  fixed tree) where it takes F, the first design elsewhere;
- ``lanes16``, ``lanes32``: the row map at 16 and 32 lanes a row (the
  library picks one by the rows), where it takes F.

Cases: the GCN CSRs (``models/citation.py:gcn_spmm_operator``: the real
edges and the self loops, ``gcn_norm`` weights) of Cora
(``datasets/graphs.py:cora_graph``: 3072 rows, ~13.6k edges) at F = 16,
the class width 7 and 128, and of PubMed after RCM (``pubmed_graph``:
24,576 rows, ~113.2k edges) at F = 16, 3 and 128; the hub graph's CSR
(``spmm_hub_operator``: 512 rows, a receiver of 500 senders, a sender of
400 receivers, random weights) at F = 16; each with fp32 and bf16 x, in
both directions (the receiver-major CSR and its transpose).

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), one with the launch floor
(``probes/common.py:floor_line``: an empty kernel's plain launch, timed
the same way), then one per case: device µs of each design with the L2
warm and flushed (median of five CUDA-graph timings of ``--calls``
calls, and their spread, ``probes/common.py:timings``), the bound
(``bounds.py:spmm_bound``), the largest error of each design against the
plain version and of the first against the shipped one (relative to the
largest magnitude), whether two launches of the shipped design are
bitwise equal, the row lengths, and the card's name and power limit.
Exits non-zero without a card.
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

SOURCE = REPO / "probes" / "spmm_csr_designs.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "first_spmm_csr": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    "lanes_spmm_csr": (_I, [_P] * 5 + [_I] * 4 + [_P]),
}
DESIGNS = ("first", "shipped")
#: Lanes a row of the row map timed beside the library's choice.
LANES = (16, 32)
#: (graph, F) of each case; each runs with fp32 and bf16 x in both
#: directions.
CASES = (("cora", 16), ("cora", 7), ("cora", 128), ("pubmed_rcm", 16),
         ("pubmed_rcm", 3), ("pubmed_rcm", 128), ("hub", 16))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SEED = 0


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def takes_row_map(f: int, x) -> bool:
    """Whether the row map takes width ``f`` for ``x``: at most 32 channel
    slots of V, V = 4 where f is a multiple of 4 and x holds four of its
    elements aligned (16 bytes of fp32, 8 of bf16), else 1 (the rule of
    ``spmm_csr.cu:dispatch_rows``, with out from torch.empty)."""
    vec = 4 if f % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 \
        else 1
    return -(-f // vec) <= 32


def designs(f: int, x):
    """The designs timed at width ``f``: ``DESIGNS``, and the row map at
    each of ``LANES`` where it takes f."""
    lanes = tuple(f"lanes{L}" for L in LANES) if takes_row_map(f, x) else ()
    return DESIGNS + lanes


def spmm(lib, design, csr, val, x, out=None):
    """One design's ``out = A x`` (fp32), into ``out`` (made from
    torch.empty if None)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design not in DESIGNS and design not in (f"lanes{L}" for L in LANES):
        raise ValueError(f"unknown design {design!r}")
    if out is None:
        out = torch.empty((csr.num_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    args = (csr.row_ptr.data_ptr(), csr.col.data_ptr(), val.data_ptr(),
            x.data_ptr(), out.data_ptr(), csr.num_rows, x.shape[1],
            int(x.dtype == torch.bfloat16))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if design == "first":
        rc = lib.first_spmm_csr(*args, stream)
    elif design == "shipped":
        rc = load_library("spmm_csr").spmm_csr(*args, stream)
    else:
        rc = lib.lanes_spmm_csr(*args, int(design[len("lanes"):]), stream)
    if rc != 0:
        why = ("the row map does not take F" if rc == -1
               else f"CUDA error {rc}")
        raise RuntimeError(f"spmm_csr_designs {design} failed: {why}")
    return out


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def compare(lib, csr, val, x):
    """Every design at x's width against the plain version, the first
    against the shipped one (relative to the largest reference
    magnitude), and whether two launches of the shipped design are
    bitwise equal: ``(errors, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr_plain

    plain = spmm_csr_plain(csr, val, x)
    got = {design: spmm(lib, design, csr, val, x)
           for design in designs(x.shape[1], x)}
    again = spmm(lib, "shipped", csr, val, x)
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel(out, plain)
              for design, out in got.items()}
    errors["first_vs_shipped"] = _rel(got["first"], got["shipped"])
    return errors, torch.equal(again, got["shipped"])


def csr_pairs():
    """{graph: {direction: (CSR, weights in CSR order)}} of the probe's
    graphs, on the card: the GCN's bound SpMM over Cora and RCM-PubMed,
    and the hub graph with random weights."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, pubmed_graph, spmm_hub_operator)
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator

    ops = {"cora": gcn_spmm_operator(cora_graph("cuda")[1]),
           "pubmed_rcm": gcn_spmm_operator(pubmed_graph("cuda")[1]),
           "hub": spmm_hub_operator("cuda", SEED)}
    pairs = {}
    for name, (op, w) in ops.items():
        val_f, val_b = op.route_weights(w)
        pairs[name] = {"fwd": (op.fwd, val_f), "bwd": (op.bwd, val_b)}
    return pairs


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
    if not require_card("spmm_csr_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import spmm_bound

    smi = card()
    emit(build_line("spmm_csr_designs", SOURCE, smi))
    emit(floor_line("spmm_csr_designs", args.calls, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for graph, pairs in csr_pairs().items():
        for name, f in CASES:
            if name != graph or name not in names:
                continue
            for dtype_name, dtype in DTYPES.items():
                for direction, (csr, val) in pairs.items():
                    x = torch.randn(csr.num_cols, f, generator=gen,
                                    device="cuda").to(dtype)
                    errors, repeat = compare(lib, csr, val, x)
                    line = {"probe": "spmm_csr_designs", "graph": graph,
                            "direction": direction, "F": f,
                            "x": dtype_name, "rows": csr.num_rows,
                            "edges": csr.num_edges, "errors": errors,
                            "bitwise_repeat": repeat,
                            "row_lengths": row_lengths(csr.row_ptr)}
                    for design in designs(f, x):
                        out = spmm(lib, design, csr, val, x)
                        line[design] = timings(
                            lambda: spmm(lib, design, csr, val, x, out),
                            args.calls)
                    line["bound_ms"], line["bound_by"] = spmm_bound(
                        csr, f, x.element_size())
                    emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
