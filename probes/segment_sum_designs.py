"""Design probe of the receiver-sorted segment sum, on one NVIDIA GPU.

    python3 probes/segment_sum_designs.py [--calls 50] [--cases dna,agnn]

Times the designs of ``sorted_segment_sum``
(``pytorch_geometric_tpu_torch/csrc/segment_sum.cuh``, launched by
``csrc/sorted_spmm.cu`` and as the second launch of the RGCN forward) on
the same inputs in one run:

- ``first``: the header's first design, a group of lanes per row, each
  lane walking the row's edges once for each of its chunks of channels
  (``sorted_segment_sum_kernel``, launched at every width by
  ``first_segment_sum`` of ``probes/segment_sum_designs.cu``);
- ``shipped``: the port's library, the first design up to 32 chunks a row
  (128 fp32 channels), the chunk map past them;
- ``chunks1``, ``chunks2``, ``chunks4``: the chunk map
  (``segment_sum_chunks_kernel``: a warp per (row, 32 VEC K channels),
  the loads of 8 edges issued together) at K = 1, 2 and 4 loads a lane
  an edge, at every width (K up to 8 / VEC: 1 for bf16 in 16-byte loads,
  2 for fp32 in them, 4 for one element a load).

Cases (graph, direction, F): the sorted GCN's CSRs of PubMed after RCM
(``models/citation.py:gcn_spmm_operator`` over
``datasets/graphs.py:pubmed_graph``: 24,576 rows, ~113.2k messages) at
F = 16 and 3, both directions; the RGCN forward's message sums over
MUTAG-RDF's receiver-major CSR (``mutag_graph``, ``rgcn_fused_ops``:
24,576 rows, 141,864 messages) at C = 16 (conv1) and 2 (conv2), and over
the hub operator's (``rgcn_hub_operator``: a receiver of 3,013 messages)
at C = 33; AGNN's sums on Cora (``nn/conv/agnn_conv.py:agnn_operators``)
by receiver at F = 1 (its softmax) and 16, by sender at 16 (its gathers'
gradients); DNA's (``dna_operators``: the GCN edge set, ~13.6k messages)
by receiver at F = 128 and its key-value gradients by sender at 256, 512,
768 and 1024 (a history of 1 to 4 layers of 256 channels). Each with
fp32 and bf16 messages.

Prints one JSON line with the build (nvcc's ``-Xptxas -v`` report: each
kernel's registers and spills, both designs), one with the launch floor
(``probes/common.py:floor_line``), then one per case: device µs of each
design and of ``torch.segment_reduce`` (the library call, on fp32
messages) with the L2 warm and flushed (median of five CUDA-graph
timings of ``--calls`` calls, and their spread,
``probes/common.py:timings``), the bound
(``bounds.py:segment_sum_bound``), the largest error of each design
against the plain version (relative to the largest magnitude), whether
each design is bitwise equal to the first (all sum each element in CSR
order in one accumulator) and whether two launches of the shipped
design are, the row lengths, and the card's name and power limit. Exits
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
    build_line, card, emit, floor_line, require_card, row_lengths, stream,
    timings)

SOURCE = REPO / "probes" / "segment_sum_designs.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "first_segment_sum": (_I, [_P] * 3 + [_I] * 3 + [_P]),
    "chunks_segment_sum": (_I, [_P] * 3 + [_I] * 4 + [_P]),
}
DESIGNS = ("first", "shipped")
#: Loads a lane an edge of the chunk map timed beside the library.
CHUNK_K = (1, 2, 4)
#: (graph, direction, F) of each case; each runs with fp32 and bf16
#: messages.
CASES = (("pubmed_rcm", "fwd", 16), ("pubmed_rcm", "bwd", 16),
         ("pubmed_rcm", "fwd", 3), ("pubmed_rcm", "bwd", 3),
         ("mutag", "fwd", 16), ("mutag", "fwd", 2), ("rgcn_hub", "fwd", 33),
         ("agnn", "fwd", 1), ("agnn", "fwd", 16), ("agnn", "bwd", 16),
         ("dna", "fwd", 128), ("dna", "bwd", 256), ("dna", "bwd", 512),
         ("dna", "bwd", 768), ("dna", "bwd", 1024))
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
SEED = 0


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def vec_of(f: int, msgs) -> int:
    """Elements a lane loads at once at width ``f``: 16 bytes where f is a
    multiple of them and msgs is 16-byte aligned, else 1 (the rule of
    ``segment_sum.cuh:vec_of``, with out from torch.empty)."""
    vec = 16 // msgs.element_size()
    return vec if f % vec == 0 and msgs.data_ptr() % 16 == 0 else 1


def designs(f: int, msgs):
    """The designs timed at width ``f``: ``DESIGNS``, and the chunk map at
    each K of ``CHUNK_K`` that it takes (at most 8 elements a lane)."""
    vec = vec_of(f, msgs)
    return DESIGNS + tuple(f"chunks{k}" for k in CHUNK_K if vec * k <= 8)


def segment_sum(lib, design, row_ptr, msgs, out=None):
    """One design's segment sum of ``msgs`` (E, F) over ``row_ptr``, fp32,
    into ``out`` (made from torch.empty if None)."""
    from pytorch_geometric_tpu_torch.kernels._build import load_library

    if design not in DESIGNS and design not in (f"chunks{k}"
                                                for k in CHUNK_K):
        raise ValueError(f"unknown design {design!r}")
    if out is None:
        out = torch.empty((row_ptr.shape[0] - 1, msgs.shape[1]),
                          dtype=torch.float32, device=msgs.device)
    args = (row_ptr.data_ptr(), msgs.data_ptr(), out.data_ptr(),
            row_ptr.shape[0] - 1, msgs.shape[1],
            int(msgs.dtype == torch.bfloat16))
    if design == "first":
        rc = lib.first_segment_sum(*args, stream())
    elif design == "shipped":
        rc = load_library("sorted_spmm").sorted_segment_sum(*args, stream())
    else:
        rc = lib.chunks_segment_sum(*args, int(design[len("chunks"):]),
                                    stream())
    if rc != 0:
        raise RuntimeError(f"segment_sum_designs {design} failed: CUDA "
                           f"error {rc}")
    return out


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def compare(lib, row_ptr, msgs):
    """Every design at msgs' width against the plain version (relative to
    the largest reference magnitude), whether each is bitwise equal to the
    first design, and whether two launches of the shipped design are:
    ``(errors, bitwise_vs_first, bitwise_repeat)``."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
        sorted_segment_sum_plain)

    plain = sorted_segment_sum_plain(row_ptr, msgs)
    got = {design: segment_sum(lib, design, row_ptr, msgs)
           for design in designs(msgs.shape[1], msgs)}
    again = segment_sum(lib, "shipped", row_ptr, msgs)
    torch.cuda.synchronize()
    errors = {f"{design}_vs_plain": _rel(out, plain)
              for design, out in got.items()}
    same = {design: torch.equal(out, got["first"])
            for design, out in got.items() if design != "first"}
    return errors, same, torch.equal(again, got["shipped"])


def row_ptrs(names=None):
    """{(graph, direction): row pointers} of the probe's CSRs on the card
    (see the head of this file), for the graphs of ``names`` (all if
    None)."""
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, mutag_graph, pubmed_graph, rgcn_hub_operator)
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from pytorch_geometric_tpu_torch.nn.conv import (
        agnn_operators, dna_operators)

    names = set(names or (c[0] for c in CASES))
    out = {}
    if "pubmed_rcm" in names:
        op = gcn_spmm_operator(pubmed_graph("cuda")[1])[0]
        out["pubmed_rcm", "fwd"] = op.fwd.row_ptr
        out["pubmed_rcm", "bwd"] = op.bwd.row_ptr
    if "mutag" in names:
        ds, mutag = mutag_graph("cuda")
        out["mutag", "fwd"] = rgcn_fused_ops(
            mutag, ds.num_relations)[0].fwd.row_ptr
    if "rgcn_hub" in names:
        out["rgcn_hub", "fwd"] = rgcn_hub_operator("cuda", SEED).fwd.row_ptr
    if names & {"agnn", "dna"}:
        cora = cora_graph("cuda")[1]
        for name, fn, recv, send in (
                ("agnn", agnn_operators, "recv_op", "send_op"),
                ("dna", dna_operators, "segment_op", "sender_op")):
            if name in names:
                ops = fn(cora)
                out[name, "fwd"] = ops[recv].csr.row_ptr
                out[name, "bwd"] = ops[send].csr.row_ptr
    return out


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
    if not require_card("segment_sum_designs"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import segment_sum_bound

    smi = card()
    emit(build_line("segment_sum_designs", SOURCE, smi))
    emit(floor_line("segment_sum_designs", args.calls, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ptrs = row_ptrs(names)
    for graph, direction, f in CASES:
        if graph not in names:
            continue
        rp = ptrs[graph, direction]
        E = int(rp[-1])
        for dtype_name, dtype in DTYPES.items():
            msgs = torch.randn(E, f, generator=gen, device="cuda").to(dtype)
            errors, same, repeat = compare(lib, rp, msgs)
            line = {"probe": "segment_sum_designs", "graph": graph,
                    "direction": direction, "F": f, "msgs": dtype_name,
                    "rows": rp.shape[0] - 1, "edges": E,
                    "vec": vec_of(f, msgs), "errors": errors,
                    "bitwise_vs_first": same, "bitwise_repeat": repeat,
                    "row_lengths": row_lengths(rp)}
            for design in designs(f, msgs):
                out = segment_sum(lib, design, rp, msgs)
                line[design] = timings(
                    lambda: segment_sum(lib, design, rp, msgs, out),
                    args.calls)
            lib_in, offsets = msgs.float(), rp.long()
            line["segment_reduce"] = timings(
                lambda: torch.segment_reduce(lib_in, "sum", offsets=offsets),
                args.calls)
            line["bound_ms"], line["bound_by"] = segment_sum_bound(
                rp.shape[0] - 1, E, f, msgs.element_size())
            emit({**line, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
