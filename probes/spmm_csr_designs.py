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
  fixed tree) where it takes F, the first design for bf16 x of 65 to
  128 channels, the chunk map elsewhere;
- ``lanes16``, ``lanes32``: the row map at 16 and 32 lanes a row (the
  library picks one by the rows), where it takes F;
- ``chunks1`` ... ``chunks16``: the chunk map
  (``spmm_csr_chunks_kernel``: a warp per (row, 32 V K channels), the
  row's columns and weights one a lane, the gathers of up to 8 edges, 32
  channels a lane, issued together) at K = 1, 2, 4, 8 and 16 loads a
  lane an edge (K up to 16 / V), at every F of 32 channels or more.

Cases: the GCN CSRs (``models/citation.py:gcn_spmm_operator``: the real
edges and the self loops, ``gcn_norm`` weights) of Cora
(``datasets/graphs.py:cora_graph``: 3072 rows, ~13.6k edges) at F = 16,
the class width 7, 33, 128, 300 and 1433 (SGC's propagation of the
features), and of PubMed after RCM (``pubmed_graph``: 24,576 rows,
~113.2k edges) at F = 16, 3 and 128; the hub graph's CSR
(``spmm_hub_operator``: 512 rows, a receiver of 500 senders, a sender of
400 receivers, random weights) at F = 16; Spline's two kernel-index CSRs
on Cora with ``TargetIndegree`` (``nn/conv/spline_conv.py:
spline_edge_sets``, dim 1, kernel size 2: ~10.5k edges each, empty rows)
at F = 1433 (its conv1); each with fp32 and bf16 x, in both directions
(the receiver-major CSR and its transpose).

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), one with the launch floor
(``probes/common.py:floor_line``: an empty kernel's plain launch, timed
the same way), then one per case: device µs of each design with the L2
warm and flushed (median of five CUDA-graph timings of ``--calls``
calls, and their spread, ``probes/common.py:timings``), cuSPARSE's
(``torch.sparse.mm`` on fp32 x, the library call), the bound
(``bounds.py:spmm_bound``), the largest error of each design against the
plain version and of the first against the shipped one (relative to the
largest magnitude), whether each design is bitwise equal to the first
(the chunk map sums in its order) and whether two launches of the
shipped design are, the row lengths, and the card's name and power
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
    build_line, card, emit, floor_line, require_card, row_lengths, timings)

SOURCE = REPO / "probes" / "spmm_csr_designs.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "first_spmm_csr": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    "lanes_spmm_csr": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    "chunks_spmm_csr": (_I, [_P] * 5 + [_I] * 4 + [_P]),
}
DESIGNS = ("first", "shipped")
#: Lanes a row of the row map timed beside the library's choice.
LANES = (16, 32)
#: Loads a lane an edge of the chunk map timed beside the library.
CHUNK_K = (1, 2, 4, 8, 16)
#: (graph, F) of each case; each runs with fp32 and bf16 x in both
#: directions.
CASES = (("cora", 16), ("cora", 7), ("cora", 128), ("cora", 33),
         ("cora", 300), ("cora", 1433), ("pubmed_rcm", 16),
         ("pubmed_rcm", 3), ("pubmed_rcm", 128), ("hub", 16),
         ("spline_k0", 1433), ("spline_k1", 1433))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SEED = 0


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def vec_of(f: int, x) -> int:
    """V at width ``f`` for ``x``: 4 where f is a multiple of 4 and x holds
    four of its elements aligned (16 bytes of fp32, 8 of bf16), else 1
    (the rule of ``spmm_csr.cu:vec_of``, with out from torch.empty)."""
    return 4 if f % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 \
        else 1


def takes_row_map(f: int, x) -> bool:
    """Whether the row map takes width ``f`` for ``x``: at most 32 channel
    slots of V (``spmm_csr.cu:dispatch_rows``)."""
    return -(-f // vec_of(f, x)) <= 32


def designs(f: int, x):
    """The designs timed at width ``f``: ``DESIGNS``, the row map at each
    of ``LANES`` where it takes f, and the chunk map at each K of
    ``CHUNK_K`` that it takes (at most 16 channels a lane) where f is 32
    or more."""
    lanes = tuple(f"lanes{L}" for L in LANES) if takes_row_map(f, x) else ()
    chunks = tuple(f"chunks{k}" for k in CHUNK_K
                   if vec_of(f, x) * k <= 16) if f >= 32 else ()
    return DESIGNS + lanes + chunks


def spmm(lib, design, csr, val, x, out=None):
    """One design's ``out = A x`` (fp32), into ``out`` (made from
    torch.empty if None)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    known = DESIGNS + tuple(f"lanes{L}" for L in LANES) + tuple(
        f"chunks{k}" for k in CHUNK_K)
    if design not in known:
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
    elif design.startswith("chunks"):
        rc = lib.chunks_spmm_csr(*args, int(design[len("chunks"):]), stream)
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
    magnitude), whether each design is bitwise equal to the first, and
    whether two launches of the shipped design are:
    ``(errors, bitwise_vs_first, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr_plain

    plain = spmm_csr_plain(csr, val, x)
    got = {design: spmm(lib, design, csr, val, x)
           for design in designs(x.shape[1], x)}
    again = spmm(lib, "shipped", csr, val, x)
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel(out, plain)
              for design, out in got.items()}
    errors["first_vs_shipped"] = _rel(got["first"], got["shipped"])
    same = {design: torch.equal(out, got["first"])
            for design, out in got.items() if design != "first"}
    return errors, same, torch.equal(again, got["shipped"])


def csr_pairs(names=None):
    """{graph: {direction: (CSR, weights in CSR order)}} of the probe's
    graphs of ``names`` (all if None), on the card: the GCN's bound SpMM
    over Cora and RCM-PubMed, the hub graph with random weights, and
    Spline's kernel-index CSRs with their basis weights."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, pubmed_graph, spmm_hub_operator)
    from pytorch_geometric_tpu_torch.examples import citation_suite
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
    from pytorch_geometric_tpu_torch.nn.conv import spline_edge_sets
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    names = set(names or (c[0] for c in CASES))
    ops = {}
    if "cora" in names:
        ops["cora"] = gcn_spmm_operator(cora_graph("cuda")[1])
    if "pubmed_rcm" in names:
        ops["pubmed_rcm"] = gcn_spmm_operator(pubmed_graph("cuda")[1])
    if "hub" in names:
        ops["hub"] = spmm_hub_operator("cuda", SEED)
    if names & {"spline_k0", "spline_k1"}:
        spline = citation_suite.load("spline", device="cuda")[1]
        for k, (s, r, b) in enumerate(spline_edge_sets(spline, 1, 2)):
            if f"spline_k{k}" in names:
                ops[f"spline_k{k}"] = (SpmmOperator(
                    s, r, spline.num_nodes, device="cuda"), b)
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
    for graph, pairs in csr_pairs(names).items():
        for name, f in CASES:
            if name != graph or name not in names:
                continue
            for dtype_name, dtype in DTYPES.items():
                for direction, (csr, val) in pairs.items():
                    x = torch.randn(csr.num_cols, f, generator=gen,
                                    device="cuda").to(dtype)
                    errors, same, repeat = compare(lib, csr, val, x)
                    line = {"probe": "spmm_csr_designs", "graph": graph,
                            "direction": direction, "F": f,
                            "x": dtype_name, "rows": csr.num_rows,
                            "edges": csr.num_edges, "errors": errors,
                            "bitwise_vs_first": same,
                            "bitwise_repeat": repeat,
                            "row_lengths": row_lengths(csr.row_ptr)}
                    for design in designs(f, x):
                        out = spmm(lib, design, csr, val, x)
                        line[design] = timings(
                            lambda: spmm(lib, design, csr, val, x, out),
                            args.calls)
                    a = torch.sparse_csr_tensor(
                        csr.row_ptr, csr.col, val,
                        (csr.num_rows, csr.num_cols))
                    x32 = x.float()
                    line["cusparse"] = timings(
                        lambda: torch.sparse.mm(a, x32), args.calls)
                    line["bound_ms"], line["bound_by"] = spmm_bound(
                        csr, f, x.element_size())
                    emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
