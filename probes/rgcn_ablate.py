"""Term-by-term ablation of the packed-RGCN backward kernel, on one NVIDIA
GPU.

    python3 probes/rgcn_ablate.py [--modes full,noindex,...] [--calls 50]
                                  [--order rcm,as_trained]

Counterpart of ``tools/rgcn_ablate.py``, which timed the TPU backward with
one TPU cost term removed per variant. The terms here are the Hopper
kernels' own (``packed_rgcn_bwd`` in ``csrc/packed_rgcn.cu``: the walk
``rgcn_bwd_kernel`` and the two launches of the ``datt`` reduction, built
with one bit of its ``rgcn_ablate`` mask set by
``probes/packed_rgcn_ablate.cu``; the tool's mode each stands in for in
brackets):

- ``full``: nothing removed, the kernels that ship;
- ``noindex``: no load of ``col[e]``; the receiver is the row itself
  (``noonehot``);
- ``noxb``: no load of the row's ``xB`` slice in the ``dae`` walk
  (``noxbgather``);
- ``nog``: no ``g[col]`` loads, in either walk;
- ``nodxb_walk``: the first walk (``dxB``) is skipped;
- ``nodae_walk``: the second walk (``dae``) is skipped;
- ``nodae_store``: the scattered (E, B) ``dae`` store is kept behind a
  run-time flag that is 0 (``noscatter``);
- ``nodxb_store``: the ``dxB`` store likewise (``noaccum``);
- ``nodatt``: the two reduction launches are skipped (``nodatt``).

Every mode but ``full`` is wrong on purpose; only its time matters.
``--calls`` is the counterpart of the tool's ``--K``; its ``--geom`` has
none (a CSR walk has no window or tile).

The graph is MUTAG-RDF at full size
(``pytorch_geometric_tpu_torch/datasets/graphs.py``), in each ``--order``:
``rcm`` as the tool reorders it, ``as_trained`` as ``train_rgcn`` sees
it. The cases are the operators ``train_rgcn`` builds
(``rgcn_fused_ops``): conv1 in embed mode, (B, C) = (30, 16), xB (24,576,
480) fp32, and conv2, (30, 2). Every mode, ``full`` included, runs
through the probe library's own table of kernel instantiations; before
timing, ``full`` is checked bitwise against the library's
``packed_rgcn_bwd``.

Occupancy: as in ``probes/gat_ablate.py``, each mode is timed as
compiled and with every mode's walk launched with the same unused
dynamic shared memory, which holds none above ``full``'s blocks per SM
(``matched``); rank terms by the matched deltas.

One JSON line per order, case and mode: device µs with the L2 warm and
flushed (median of five CUDA-graph timings of ``--calls`` calls, and
their spread) and the delta against ``full``, as compiled and
occupancy-matched; the bound, the row-length summary of the walked
sender-major CSR (max, p99, mean: a hub row's tail against a per-edge
cost), whether the output was finite, and the card's name and power
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
    build_line, card, emit, occupancy_padding, require_card, row_lengths,
    stream, timings)

SOURCE = REPO / "probes" / "packed_rgcn_ablate.cu"
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
SIGNATURES = {
    "packed_rgcn_ablate_bwd": (_I, [_P] * 13 + [_I] * 5
                               + [_U, _I, _I, _P]),
    "packed_rgcn_ablate_occupancy": (_I, [_U, _I, _I, ctypes.POINTER(_I)]),
    "packed_rgcn_pipe_fwd": (_I, [_P] * 9 + [_I] * 6 + [_P]),
}
#: Mode -> bit of ``rgcn_ablate`` in ``csrc/packed_rgcn.cu`` (0: nothing
#: removed).
MODES = {"full": 0, "noindex": 1 << 0, "noxb": 1 << 1, "nog": 1 << 2,
         "nodxb_walk": 1 << 3, "nodae_walk": 1 << 4, "nodae_store": 1 << 5,
         "nodxb_store": 1 << 6, "nodatt": 1 << 7}
#: (case, B, C, which of rgcn_fused_ops' two operators).
CASES = (("conv1", 30, 16, 0), ("conv2", 30, 2, 1))
SEED = 0


def load():
    """The probe's library (the backward's modes and the forward's
    prefetch depths), built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def ablate_bwd(lib, op, xB, att, g, mode="full", out=None, smem=0):
    """``(dxB, datt)`` of ``packed_rgcn_bwd`` with ``mode`` removed, into
    ``out`` (made if None, zeroed: dxB, datt and the scratch dae and
    partial; a mode that skips a store leaves zeros), the walk with
    ``smem`` bytes of unused dynamic shared memory per block (see
    :func:`blocks_per_sm`)."""
    from pytorch_geometric_tpu_torch.ops.packed_rgcn import DATT_SPLITS

    csr = op.bwd
    R, B = att.shape
    C = xB.shape[1] // B
    if out is None:
        # checked here, never inside a CUDA-graph capture (it reads back)
        if MODES[mode] & MODES["noindex"] and csr.num_rows > csr.num_cols \
                and int(csr.row_ptr[csr.num_cols]) != csr.num_edges:
            raise ValueError("noindex reads g at the sender's row: every "
                             "row with edges must be a row of g")
        dev = xB.device
        out = (torch.zeros(csr.num_rows, B * C, device=dev),
               torch.zeros(R, B, device=dev),
               torch.zeros(csr.num_edges, B, device=dev),
               torch.zeros(R, DATT_SPLITS, B, device=dev))
    rc = lib.packed_rgcn_ablate_bwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), op.bwd_et.data_ptr(),
        op.bwd_w.data_ptr(), op.bwd_pos.data_ptr(), op.rel_ptr.data_ptr(),
        xB.data_ptr(), att.data_ptr(), g.data_ptr(),
        *(t.data_ptr() for t in out), csr.num_rows, R, B, C, DATT_SPLITS,
        MODES[mode], 0, smem, stream())
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_ablate_bwd ({mode}) failed: CUDA "
                           f"error {rc}")
    ablate_bwd.launches += 1 if MODES[mode] & MODES["nodatt"] else 3
    return out[:2]


#: Launches of the probe's kernels (the walk and the two reduction
#: steps, as ``packed_rgcn_bwd`` counts them).
ablate_bwd.launches = 0


def blocks_per_sm(lib, mode, C, smem):
    """Blocks per SM of ``mode``'s walk kernel at ``C`` channels with
    ``smem`` bytes of dynamic shared memory per block (the occupancy
    calculator; raises the kernel's limit above 48 KB, so call it before
    such a launch)."""
    blocks = ctypes.c_int(0)
    rc = lib.packed_rgcn_ablate_occupancy(MODES[mode], C, smem,
                                          ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"packed_rgcn_ablate_occupancy ({mode}, C={C}, "
                           f"smem={smem}) failed: CUDA error {rc}")
    return blocks.value


def inputs(op, B, C, gen):
    """Random xB (source rows, B*C), att (R, B) and g (nodes, C)."""
    xB = torch.randn(op.num_src_rows, B * C, generator=gen, device="cuda")
    att = torch.randn(op.R, B, generator=gen, device="cuda")
    g = torch.randn(op.num_nodes, C, generator=gen, device="cuda")
    return xB, att, g


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import ORDERS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--order", default=",".join(ORDERS))
    args = ap.parse_args(argv)
    modes, orders = args.modes.split(","), args.order.split(",")
    unknown = sorted(set(modes) - set(MODES)) + sorted(set(orders)
                                                       - set(ORDERS))
    if unknown:
        ap.error(f"unknown modes or orders {unknown}; known: {list(MODES)}, "
                 f"{list(ORDERS)}")
    if not require_card("rgcn_ablate"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import rgcn_bound
    from pytorch_geometric_tpu_torch.datasets.graphs import mutag_graph
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    smi = card()
    emit(build_line("rgcn_ablate", SOURCE, smi))
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for order in orders:
        ds, graph = mutag_graph("cuda", order)
        ops = rgcn_fused_ops(graph, ds.num_relations)
        for case, B, C, which in CASES:
            op = ops[which]
            xB, att, g = inputs(op, B, C, gen)
            got = ablate_bwd(lib, op, xB, att, g)
            want = pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w,
                                      op.bwd_pos, op.rel_ptr, xB, att, g)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"full mode differs from "
                                     f"packed_rgcn_bwd ({order}, {case})")
            bound, bound_by = rgcn_bound(op, B, C, backward=True)
            lengths = row_lengths(op.bwd.row_ptr)
            order_modes = ["full"] + [md for md in modes if md != "full"]
            smem, target = occupancy_padding(
                lambda md, sm: blocks_per_sm(lib, md, C, sm), order_modes)
            base = {}
            for mode in order_modes:
                out = ablate_bwd(lib, op, xB, att, g, mode)
                torch.cuda.synchronize()
                finite = all(bool(torch.isfinite(t).all()) for t in out)
                scratch = out + (torch.zeros(op.E, B, device="cuda"),
                                 torch.zeros(op.R, pr.DATT_SPLITS, B,
                                             device="cuda"))
                line = {}
                for key, pad in (("compiled", 0), ("matched", smem)):
                    t = timings(lambda: ablate_bwd(lib, op, xB, att, g, mode,
                                                   scratch, pad), args.calls)
                    base.setdefault(key, t)
                    line[key] = {
                        "smem": pad,
                        "blocks_per_sm": blocks_per_sm(lib, mode, C, pad),
                        **t,
                        "delta_warm_us": t["warm_us"] - base[key]["warm_us"],
                        "delta_flushed_us": (t["flushed_us"]
                                             - base[key]["flushed_us"])}
                if mode in modes:
                    emit({"probe": "rgcn_ablate", "graph": "mutag",
                          "order": order, "case": case, "B": B, "C": C,
                          "R": op.R, "rows": op.bwd.num_rows,
                          "edges": op.E, "mode": mode, "bit": MODES[mode],
                          "row_lengths": lengths, **line["compiled"],
                          "matched": line["matched"],
                          "full_blocks_per_sm": target,
                          "bound_ms": bound, "bound_by": bound_by,
                          "finite": finite, "calls": args.calls,
                          "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
