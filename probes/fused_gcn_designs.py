"""Design probe of the fused two-layer GCN kernel, on one NVIDIA GPU.

    python3 probes/fused_gcn_designs.py [--calls 50]

Builds ``probes/fused_gcn_designs.cu`` (which includes
``csrc/fused_gcn.cu``) with the port's nvcc flags
(``kernels/_build.py:build_source``, cached by a hash of the source and
what it includes) into the git-ignored ``pytorch_geometric_tpu_torch/_build/``
and prints one JSON line each for:

- ``build``: nvcc's register and spill report of every kernel;
- ``empty``: device µs of a cooperative launch of an empty kernel with 0,
  1 and 2 grid barriers, at 192 and 1056 blocks of 256 threads, and of a
  plain empty launch (what a barrier costs);
- ``designs``, per graph (Cora with (H, C) = (16, 7), PubMed after RCM
  with (16, 3)) and dropout rate (0, 0.5): forward and backward device µs
  (:func:`probes.common.timings`: warm and L2-flushed, median of five and
  spread) and largest relative error against the plain versions
  (``ops/fused_gcn.py``) of the earlier design (``earlier``: two barriers, a
  pass for the per-node step, the edges one after another), of the
  library's call (``shipped``), of the shipped design as one cooperative
  launch at 4, 8 and 16 lanes a row, at most 1, 2 and 4 blocks an SM and
  4 or 8 edges a lane loads at once (``coop_l<L>_b<B>_e<NB>``, with the
  grid it launched) and as two plain launches (``two_l<L>_e<NB>``) or
  two with programmatic dependent launch (``pdl_l<L>_e<NB>``), and
  ``earlier`` and ``shipped`` again at the end; with the bounds and both
  CSRs' row lengths;
- ``gathers``, per graph: device µs of torch's row gathers ``x[col]`` of
  the sorted backend (F = 16, the GCN CSR's columns) by each indexing
  call, of the weight gather, and of the whole ``SortedSpmm`` call.

Every design's outputs are checked within 1e-5 of the plain versions and
two launches of each bitwise equal before it is timed. Exits non-zero
without a card.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import build_line, emit, require_card, card  # noqa: E402
from probes.common import row_lengths, timings  # noqa: E402
from probes.common import stream as _stream  # noqa: E402
from pytorch_geometric_tpu_torch.profiling import device_ms  # noqa: E402

SOURCE = REPO / "probes" / "fused_gcn_designs.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ARGS = [_I] + [_P] * 11 + [_I] * 3 + [_U, _F, _I]
SIGNATURES = {
    "probe_design": (_I, _ARGS + [_I] * 4 + [_P]),
    "probe_earlier": (_I, _ARGS + [_P]),
    "probe_empty": (_I, [_I, _I, _I, _P]),
    "probe_last_blocks": (_I, [_I]),
    "probe_library_options": (_I, [ctypes.POINTER(_I)] * 2),
}
CASES = (("cora", 7), ("pubmed_rcm", 3))
RATES = (0.0, 0.5)
LANES = (4, 8, 16)
BLOCKS_PER_SM = (1, 2, 4)
BATCHES = (4, 8)
SEED = 0
GAT_SEED = 123457
TOL = 1e-5


def load():
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def variants():
    """The design variants the probe launches, by name: ``(lanes,
    blocks per SM, launch form, edges a lane loads at once)`` of the
    shipped design's walks (form 0: one cooperative launch; 1: two plain
    launches; 2: two, the second programmatic, as the library), or None
    for the earlier design."""
    out = {"earlier": None}
    for batch in BATCHES:
        for lanes in LANES:
            for bps in BLOCKS_PER_SM:
                out[f"coop_l{lanes}_b{bps}_e{batch}"] = (lanes, bps, 0,
                                                         batch)
            out[f"two_l{lanes}_e{batch}"] = (lanes, 0, 1, batch)
            out[f"pdl_l{lanes}_e{batch}"] = (lanes, 0, 2, batch)
    return out


def library_options(lib):
    """``(lanes a row, edges a lane loads at once)``, the constants of
    the library's call (``csrc/fused_gcn.cu:kLanes``, ``kBatch``)."""
    got = [ctypes.c_int() for _ in range(2)]
    lib.probe_library_options(*(ctypes.byref(v) for v in got))
    return tuple(v.value for v in got)


def probe_empty(lib):
    times = {}
    for coop, barriers in ((1, 0), (1, 1), (1, 2), (0, 0)):
        for blocks in (192, 1056):
            def call():
                rc = lib.probe_empty(coop, barriers, blocks, _stream())
                assert rc == 0, rc
            key = (f"cooperative_{barriers}_barriers" if coop
                   else "plain") + f"_{blocks}_blocks"
            times[key] = device_ms(call) * 1e3
    emit({"probe": "empty", "us": times})


class Case:
    """One graph's fused operator at (16, C) and a dropout rate, with
    random inputs, the plain versions' outputs and the buffers the
    probe's launches write."""

    def __init__(self, graph, C, rate, gen, H=16):
        from pytorch_geometric_tpu_torch.models.citation import gcn_edge_set
        from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

        s, r, w = gcn_edge_set(graph)
        n = graph.num_nodes
        self.n, self.H, self.C, self.rate = n, H, C, rate
        self.op = fg.FusedGcn2(s, r, n, w, hidden=H, classes=C,
                               device="cuda")
        self.z1 = torch.randn(n, H, generator=gen, device="cuda")
        self.g2 = torch.randn(n, C, generator=gen, device="cuda")
        self.W2 = torch.randn(H, C, generator=gen, device="cuda") * 0.5
        self.b1 = torch.randn(H, generator=gen, device="cuda") * 0.1
        self.seed = torch.tensor([GAT_SEED], dtype=torch.int32,
                                 device="cuda")
        self.fwd = (self.op.op.fwd, self.op.val_f, self.z1, self.W2, self.b1,
                    self.seed, rate)
        self.want_f = fg.fused_gcn_fwd_plain(*self.fwd)
        self.bwd = (self.op.op.bwd, self.op.val_b, self.g2, self.W2, self.b1,
                    self.want_f[0], self.seed, rate)
        self.want_b = fg.fused_gcn_bwd_plain(*self.bwd)

    def buffers(self, backward, padded):
        """The launch's three outputs: (h1_pre, z2, out) forward, (gA2,
        dh1, dz1) backward; the scratch padded to a multiple of 4 floats
        for the shipped design."""
        from pytorch_geometric_tpu_torch.ops.fused_gcn import _padded

        H, C = self.H, self.C
        widths = (C, H, H) if backward else (H, C, C)
        pad = _padded(widths[1]) if padded else widths[1]
        return [torch.empty(self.n, k, device="cuda")
                for k in (widths[0], pad, widths[2])]

    def run(self, lib, design, backward, outs):
        """One launch of ``design`` (a :func:`variants` value) into
        ``outs``: ``(h1_pre, out)`` forward, ``(gA2, dz1)`` backward."""
        from pytorch_geometric_tpu_torch.ops.fused_gcn import keep_threshold

        csr, val, x = ((self.op.op.bwd, self.op.val_b, self.g2) if backward
                       else (self.op.op.fwd, self.op.val_f, self.z1))
        h1_pre = self.want_f[0] if backward else None
        args = (int(backward), csr.row_ptr.data_ptr(), csr.col.data_ptr(),
                val.data_ptr(), x.data_ptr(), self.W2.data_ptr(),
                self.b1.data_ptr(), self.seed.data_ptr(),
                None if h1_pre is None else h1_pre.data_ptr(),
                *(t.data_ptr() for t in outs), self.n, self.H, self.C,
                keep_threshold(self.rate), float(1.0 - self.rate),
                int(self.rate > 0.0))
        rc = (lib.probe_earlier(*args, _stream()) if design is None
              else lib.probe_design(*args, *design, _stream()))
        if rc != 0:
            raise RuntimeError(f"fused GCN design {design} failed: CUDA "
                               f"error {rc}")
        return outs[0], outs[2]

    def library(self, backward):
        from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

        return (fg.fused_gcn_bwd(*self.bwd) if backward
                else fg.fused_gcn_fwd(*self.fwd))

    def check(self, got, backward):
        """The largest error of one launch's outputs relative to the
        largest magnitude of the plain version's."""
        want = self.want_b if backward else self.want_f
        return max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(got, want))


def measure(lib, case, name, design, calls):
    """Forward and backward of one design at ``case``: errors against the
    plain versions, two launches bitwise equal, the grid, and the µs of
    :func:`probes.common.timings`."""
    row = {}
    for direction, backward in (("fwd", False), ("bwd", True)):
        if name == "shipped":
            got, again = case.library(backward), case.library(backward)
            call = lambda: case.library(backward)  # noqa: E731
            blocks = None
        else:
            outs = case.buffers(backward, design is not None)
            got = [t.clone() for t in case.run(lib, design, backward, outs)]
            again = case.run(lib, design, backward, outs)
            blocks = lib.probe_last_blocks(int(design is None))
            call = lambda: case.run(lib, design, backward, outs)  # noqa
        torch.cuda.synchronize()
        err = case.check(got, backward)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not (err <= TOL and same):
            raise AssertionError(f"{name} {direction}: rel err {err} "
                                 f"(tol {TOL}), bitwise repeat {same}")
        t = timings(call, calls)
        row[direction] = {"rel_err": err, "blocks": blocks, **t}
    return row


def compare(lib, graph, C, rate, gen, calls=50):
    """The earlier design beside the library's call and the shipped walks in
    the other launch forms at the library's lanes and edges (one
    cooperative launch at 4 blocks an SM, two plain launches), at one
    graph, (16, C) and rate: the ``measure`` rows by name (what
    ``chip_smoke.py``'s probe phase runs)."""
    case = Case(graph, C, rate, gen)
    lanes, batch = library_options(lib)
    forms = (("earlier", None), ("shipped", ()),
             (f"coop_l{lanes}_b4_e{batch}", (lanes, 4, 0, batch)),
             (f"two_l{lanes}_e{batch}", (lanes, 0, 1, batch)))
    return {name: measure(lib, case, name, design, calls)
            for name, design in forms}


def probe_designs(lib, graph_name, graph, C, gen, calls):
    from pytorch_geometric_tpu_torch.bounds import fused_gcn_bound

    for rate in RATES:
        case = Case(graph, C, rate, gen)
        order = [("earlier", None), ("shipped", ())]
        order += [(k, v) for k, v in variants().items() if v is not None]
        order += [("shipped_again", ()), ("earlier_again", None)]
        rows = {}
        for name, design in order:
            rows[name] = measure(lib, case, name.replace("_again", ""),
                                 design, calls)
        fwd, bwd = case.op.op.fwd, case.op.op.bwd
        emit({"probe": "designs", "graph": graph_name, "H": case.H, "C": C,
              "rate": rate, "rows": case.n, "edges": fwd.num_edges,
              "row_lengths": {"fwd": row_lengths(fwd.row_ptr),
                              "bwd": row_lengths(bwd.row_ptr)},
              "bound_us": {d: fused_gcn_bound(case.n, fwd.num_edges, case.H,
                                              C, d == "bwd")[0] * 1e3
                           for d in ("fwd", "bwd")},
              "library_options": library_options(lib), "designs": rows,
              "card": card()})


def probe_gathers(graph_name, graph, gen):
    from pytorch_geometric_tpu_torch.models.citation import gcn_edge_set
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSpmm

    s, r, w = gcn_edge_set(graph)
    sop = SortedSpmm(s, r, graph.num_nodes, device="cuda")
    csr = sop.fwd
    x = torch.randn(graph.num_nodes, 16, generator=gen, device="cuda")
    col64 = csr.col.long()
    calls = {"index_select_int32": lambda: x.index_select(0, csr.col),
             "index_select_int64": lambda: x.index_select(0, col64),
             "advanced_index_int32": lambda: x[csr.col],
             "advanced_index_int64": lambda: x[col64],
             "embedding": lambda: torch.nn.functional.embedding(col64, x),
             "weight_gather": lambda: w[csr.perm],
             "sorted_spmm_call": lambda: sop._run(csr, w, x)}
    emit({"probe": "gathers", "graph": graph_name, "F": 16,
          "edges": csr.num_edges,
          "us": {k: device_ms(f) * 1e3 for k, f in calls.items()}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not require_card("fused_gcn_designs"):
        return 1
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, pubmed_graph)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    emit(build_line("fused_gcn_designs", SOURCE, smi))
    lib = load()
    probe_empty(lib)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    graphs = {"cora": cora_graph("cuda")[1],
              "pubmed_rcm": pubmed_graph("cuda")[1]}
    for graph_name, C in CASES:
        probe_designs(lib, graph_name, graphs[graph_name], C, gen,
                      args.calls)
        probe_gathers(graph_name, graphs[graph_name], gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
