"""Design probe of the fused two-layer GCN kernel, on one NVIDIA GPU.

    python3 probes/fused_gcn_designs.py

Builds ``probes/fused_gcn_designs.cu`` with the port's nvcc flags
(``kernels/_build.py:build_source``, cached by a hash of the source and
what it includes) into the git-ignored ``pytorch_geometric_tpu_torch/_build/``
and prints one JSON line each for:

- ``empty``: device µs of a cooperative launch of an empty kernel with 0,
  1 and 2 grid barriers, at 192 and 1056 blocks of 256 threads, and of a
  plain empty launch (what a barrier costs);
- ``designs``, per graph (Cora with (H, C) = (16, 7), PubMed after RCM
  with (16, 3)) and dropout rate (0, 0.5): forward and backward device µs
  and largest relative error against the plain versions of the port's
  kept kernels (``ops/fused_gcn.py``) and of the probe's variants (see the
  .cu file), the per-element two-barrier one capped at 2, 4 and 8 blocks
  per SM, with the grid each launched (the occupancy limit may cut a
  cap);
- ``gathers``, per graph: device µs of torch's row gathers ``x[col]`` of
  the sorted backend (F = 16, the GCN CSR's columns) by each indexing
  call, of the weight gather, and of the whole ``SortedSpmm`` call.

Times are CUDA graphs of 50 calls timed with CUDA events
(``profiling.device_ms``). Exits non-zero without a card.
"""

import ctypes
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import emit, require_card, card  # noqa: E402
from probes.common import stream as _stream  # noqa: E402
from pytorch_geometric_tpu_torch.profiling import device_ms  # noqa: E402

SOURCE = REPO / "probes" / "fused_gcn_designs.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
SIGNATURES = {
    "probe_run": (_I, [_I, _I] + [_P] * 11 + [_I] * 3 + [_U, _F, _I, _I, _P]),
    "probe_empty": (_I, [_I, _I, _I, _P]),
    "probe_last_blocks": (_I, []),
}
SMS = 132
BLOCK_CAPS = {"2_per_sm": 2 * SMS, "4_per_sm": 4 * SMS, "8_per_sm": 8 * SMS}
SEED = 0
GAT_SEED = 123457


def build():
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


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


def _variant(lib, variant, fused, backward, inputs, outs, rate, cap):
    from pytorch_geometric_tpu_torch.ops.fused_gcn import keep_threshold

    csr = fused.op.bwd if backward else fused.op.fwd
    val = fused.val_b if backward else fused.val_f
    x, W2, b1, seed, h1_pre = inputs
    rc = lib.probe_run(
        variant, int(backward), csr.row_ptr.data_ptr(), csr.col.data_ptr(),
        val.data_ptr(), x.data_ptr(), W2.data_ptr(), b1.data_ptr(),
        seed.data_ptr(), None if h1_pre is None else h1_pre.data_ptr(),
        *(t.data_ptr() for t in outs), fused.N, *W2.shape,
        keep_threshold(rate), float(1.0 - rate), int(rate > 0.0), cap,
        _stream())
    assert rc == 0, rc
    return outs


def _rel(got, want):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def probe_designs(lib, graph_name, graph, C, gen):
    from pytorch_geometric_tpu_torch.models.citation import gcn_edge_set
    from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

    s, r, w = gcn_edge_set(graph)
    n, H = graph.num_nodes, 16
    fused = fg.FusedGcn2(s, r, n, w, hidden=H, classes=C, device="cuda")
    z1 = torch.randn(n, H, generator=gen, device="cuda")
    g2 = torch.randn(n, C, generator=gen, device="cuda")
    W2 = torch.randn(H, C, generator=gen, device="cuda") * 0.5
    b1 = torch.randn(H, generator=gen, device="cuda") * 0.1
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device="cuda")
    for rate in (0.0, 0.5):
        fwd = (fused.op.fwd, fused.val_f, z1, W2, b1, seed, rate)
        want_f = fg.fused_gcn_fwd_plain(*fwd)
        bwd = (fused.op.bwd, fused.val_b, g2, W2, b1, want_f[0], seed, rate)
        want_b = fg.fused_gcn_bwd_plain(*bwd)
        kept_f, kept_b = fg.fused_gcn_fwd(*fwd), fg.fused_gcn_bwd(*bwd)
        rows = {"kept": {
            "fwd_us": device_ms(lambda: fg.fused_gcn_fwd(*fwd)) * 1e3,
            "bwd_us": device_ms(lambda: fg.fused_gcn_bwd(*bwd)) * 1e3,
            "rel_err": max(_rel(kept_f, want_f), _rel(kept_b, want_b))}}
        runs = [(1, "resident", 0)]
        runs += [(2, name, cap) for name, cap in BLOCK_CAPS.items()]
        runs += [(3, "4_per_sm", BLOCK_CAPS["4_per_sm"]), (4, "plain", 0)]
        for variant, grid, cap in runs:
            fo = [torch.empty(n, k, device="cuda") for k in (H, C, C)]
            bo = [torch.empty(n, k, device="cuda") for k in (C, H, H)]
            f_in, b_in = (z1, W2, b1, seed, None), (g2, W2, b1, seed,
                                                   want_f[0])
            _variant(lib, variant, fused, False, f_in, fo, rate, cap)
            _variant(lib, variant, fused, True, b_in, bo, rate, cap)
            torch.cuda.synchronize()
            err = max(_rel((fo[0], fo[2]), want_f),
                      _rel((bo[0], bo[2]), want_b))
            rows[f"variant{variant}_{grid}"] = {
                "blocks": lib.probe_last_blocks(),
                "fwd_us": device_ms(lambda: _variant(
                    lib, variant, fused, False, f_in, fo, rate, cap)) * 1e3,
                "bwd_us": device_ms(lambda: _variant(
                    lib, variant, fused, True, b_in, bo, rate, cap)) * 1e3,
                "rel_err": err}
        emit({"probe": "designs", "graph": graph_name, "H": H, "C": C,
                 "rate": rate, "rows": n, "edges": fused.op.fwd.num_edges,
                 "designs": rows})


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


def main():
    if not require_card("fused_gcn_designs"):
        return 1
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        cora_graph, pubmed_graph)

    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"probe": "card", "card": card()})
    lib = build()
    probe_empty(lib)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _, cora = cora_graph("cuda")
    _, pubmed, _ = pubmed_graph("cuda")
    for graph_name, graph, C in (("cora", cora, 7), ("pubmed_rcm", pubmed, 3)):
        probe_designs(lib, graph_name, graph, C, gen)
        probe_gathers(graph_name, graph, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
