"""Term-by-term ablation of the packed-GAT backward kernel, on one NVIDIA
GPU.

    python3 probes/gat_ablate.py [--modes full,noindex,...] [--rate 0.6]
                                 [--calls 50]

Counterpart of ``tools/gat_ablate.py``, which timed the TPU backward with
one TPU cost term removed per variant. The terms here are the Hopper
kernel's own (``gat_bwd_kernel`` in ``csrc/packed_gat.cu``, built with
one bit of its ``gat_ablate`` mask set by ``probes/packed_gat_ablate.cu``;
the tool's mode each stands in for in brackets):

- ``full``: nothing removed, the kernel that ships;
- ``noindex``: no load of ``col[e]`` (nor, walk 1, its use as a row
  index); the neighbour is the row itself, so every gather hits the row's
  own lines (``noonehot``);
- ``nogather_s``: the neighbour's ``s`` (walk 0) or ``d`` (walk 1) is the
  row's own, loaded once (``nogather_sh``);
- ``nogather_g``: walk 1's gathers of ``gnum`` and ``gden`` are the row's
  own, loaded once (``nogather_dg``, ``noconcat``). Walk 0 has no such
  gather: its ``g`` is its own row's, which the kernel loads once per row
  anyway, so the bit removes nothing there;
- ``nogather_h``: walk 0's gather of ``h[send]`` for the dot is the row's
  own, loaded once. Walk 1's ``h`` is its own row's, loaded once per row
  anyway: nothing to remove there;
- ``noexp``: no ``expf`` (``noexp``);
- ``nodrop``: no dropout hash (``nodrop``);
- ``noshuffle``: the dot is one lane's and has no shuffle since the
  redesign (the first design shuffled it over a group: ``nosplit``); the
  bit now removes the only shuffles left, those that merge the entry
  groups' sums of a row;
- ``nostore``: ``dd``, ``ds`` and ``dh`` stored only behind a run-time
  flag that is 0 (``noscatter``, ``noaccum``, ``nodd``).

The kernel is the redesigned one: a sub-warp per CSR row over all heads,
each lane one head of a few edges, so each edge's index and each (edge,
head)'s terms are loaded and formed once, and the neighbour's row is
gathered whole across the lanes (its first design, a group of lanes per
(row, head), is timed beside it by ``probes/packed_gat_designs.py``).
Since that redesign no lane repeats another's scalar work, so ``noexp``
and ``nodrop`` remove less than they did.

Every mode but ``full`` is wrong on purpose; only its time matters. The
tool's ``--geom`` has no counterpart: a CSR walk has no window or tile.
``--calls`` is the counterpart of its ``--K``.

The graph is RCM-PubMed at full width
(``pytorch_geometric_tpu_torch/datasets/graphs.py``: 24,576 rows, ~113.2k
edges), (H, C) = (8, 8), attention dropout ``--rate``. Every mode,
``full`` included, runs through the probe library's own table of kernel
instantiations (the lane maps of the main path's widths); before timing,
``full`` is checked bitwise against the library's ``packed_gat_bwd``. The
kernel has two launches (walks) where the TPU kernel had one, and each is
timed alone: walk 0 over the receiver-major CSR (``dd``), walk 1 over the
sender-major CSR (``ds``, ``dh``).

Occupancy. A variant that frees registers fits more blocks per SM than
``full`` and gains from that as well as from its term. So each mode is
timed twice: as compiled (``blocks_per_sm`` its own), and with every
mode, ``full`` included, launched with the same dynamic shared memory
(``matched.smem``, unused by the kernel) that holds none above ``full``'s
blocks per SM (``probes/common.py:occupancy_padding``). Rank terms by the
matched deltas; a mode with more registers than ``full`` stays below its
count (``matched.blocks_per_sm``).

One JSON line per mode and walk: device µs with the L2 warm and flushed
(median of five CUDA-graph timings of ``--calls`` calls, and their
spread) and the delta against ``full``, as compiled and occupancy-matched;
the walk's bound, whether the output was finite, and the card's name and
power limit. Exits non-zero without a card.
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

SOURCE = REPO / "probes" / "packed_gat_ablate.cu"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
SIGNATURES = {
    "packed_gat_ablate_bwd": (_I, [_P] * 11 + [_I] * 3
                              + [_U, _F, _F, _I, _U, _I, _I, _P]),
    "packed_gat_ablate_occupancy": (_I, [_U] + [_I] * 5
                                    + [ctypes.POINTER(_I)]),
}
#: Mode -> bit of ``gat_ablate`` in ``csrc/packed_gat.cu`` (0: nothing
#: removed).
MODES = {"full": 0, "noindex": 1 << 0, "nogather_s": 1 << 1,
         "nogather_g": 1 << 2, "nogather_h": 1 << 3, "noexp": 1 << 4,
         "nodrop": 1 << 5, "noshuffle": 1 << 6, "nostore": 1 << 7}
H, C = 8, 8
SEED = 0
GAT_SEED = 123457


def load():
    """The probe's library, built from ``SOURCE`` if needed."""
    from pytorch_geometric_tpu_torch.kernels._build import build_source

    return build_source(SOURCE, SIGNATURES)


def ablate_walk(lib, op, d, s, h, m, seed, g, rate, mode, walk, out=None,
                smem=0):
    """One walk of the backward with ``mode`` removed, into ``out`` (made
    if None, zeroed: a mode that skips the stores leaves zeros), with
    ``smem`` bytes of unused dynamic shared memory per block (see
    :func:`blocks_per_sm`): walk 0 gives ``(dd,)``, walk 1 ``(ds, dh)``."""
    from pytorch_geometric_tpu_torch.ops.packed_gat import _launch_args

    n, H = d.shape
    C = h.shape[1] // H
    if out is None:
        out = ((torch.zeros(n, H, device=d.device),) if walk == 0 else
               (torch.zeros(n, H, device=d.device),
                torch.zeros(n, H * C, device=d.device)))
    csr, eid = (op.fwd, None) if walk == 0 else (op.bwd, op.bwd_eid)
    tail = _launch_args(rate, op.slope, torch.cuda.current_stream()
                        .cuda_stream)
    rc = lib.packed_gat_ablate_bwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(),
        None if eid is None else eid.data_ptr(), d.data_ptr(), s.data_ptr(),
        h.data_ptr(), m.data_ptr(), g.data_ptr(), seed.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr() if walk else None, n, H, C,
        *tail[:3], walk, MODES[mode], 0, smem, stream())
    if rc != 0:
        raise RuntimeError(f"packed_gat_ablate_bwd ({mode}, walk {walk}) "
                           f"failed: CUDA error {rc}")
    ablate_walk.launches += 1
    return out


#: Launches of the probe's kernel (one per walk).
ablate_walk.launches = 0


def blocks_per_sm(lib, mode, walk, n, H, C, smem):
    """Blocks per SM of ``mode``'s kernel for ``walk`` at the lane map of
    ``n`` rows of ``(H, C)`` with ``smem`` bytes of dynamic shared memory
    per block (the occupancy calculator; raises the kernel's limit above
    48 KB, so call it before such a launch)."""
    blocks = ctypes.c_int(0)
    rc = lib.packed_gat_ablate_occupancy(MODES[mode], walk, n, H, C, smem,
                                         ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"packed_gat_ablate_occupancy ({mode}, walk "
                           f"{walk}, n={n}, H={H}, C={C}, smem={smem}) "
                           f"failed: CUDA error {rc}")
    return blocks.value


def ablate_bwd(lib, op, d, s, h, m, seed, g, rate, mode):
    """Both walks: ``(dd, ds, dh)``, as ``packed_gat_bwd`` returns them."""
    return (ablate_walk(lib, op, d, s, h, m, seed, g, rate, mode, 0)
            + ablate_walk(lib, op, d, s, h, m, seed, g, rate, mode, 1))


def inputs(op, gen):
    """Random d, s, h, g at (H, C) over ``op``'s rows, the shift's m (each
    receiver's max of s over its senders, as the forward gives it) and
    the dropout seed."""
    from pytorch_geometric_tpu_torch.ops.packed_gat import receiver_max

    n = op.n
    d, s = (torch.randn(n, H, generator=gen, device="cuda")
            for _ in range(2))
    h = torch.randn(n, H * C, generator=gen, device="cuda")
    g = torch.randn(n, H * C + H, generator=gen, device="cuda")
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device="cuda")
    return d, s, h, receiver_max(op.fwd, s), seed, g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--rate", type=float, default=0.6)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = sorted(set(modes) - set(MODES))
    if unknown:
        ap.error(f"unknown modes {unknown}; known: {list(MODES)}")
    if not require_card("gat_ablate"):
        return 1
    from pytorch_geometric_tpu_torch.bounds import gat_walk_bound
    from pytorch_geometric_tpu_torch.datasets.graphs import pubmed_graph
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    smi = card()
    emit(build_line("gat_ablate", SOURCE, smi))
    lib = load()
    _, graph, _ = pubmed_graph("cuda")
    op = gat_flash_op(graph)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d, s, h, m, seed, g = inputs(op, gen)
    rate = args.rate
    got = ablate_bwd(lib, op, d, s, h, m, seed, g, rate, "full")
    want = pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g,
                             rate, op.slope)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("full mode differs from packed_gat_bwd")
    walks = {0: ("receiver-major", op.fwd), 1: ("sender-major", op.bwd)}
    order = ["full"] + [md for md in modes if md != "full"]
    for walk, (csr_name, csr) in walks.items():
        smem, target = occupancy_padding(
            lambda md, sm: blocks_per_sm(lib, md, walk, op.n, H, C, sm),
            order)
        bound, bound_by = gat_walk_bound(op, H, C, walk)
        base = {}
        for mode in order:
            out = ablate_walk(lib, op, d, s, h, m, seed, g, rate, mode, walk)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in out)
            line = {}
            for key, pad in (("compiled", 0), ("matched", smem)):
                t = timings(lambda: ablate_walk(lib, op, d, s, h, m, seed, g,
                                                rate, mode, walk, out, pad),
                            args.calls)
                base.setdefault(key, t)
                line[key] = {
                    "smem": pad,
                    "blocks_per_sm": blocks_per_sm(lib, mode, walk, op.n,
                                                   H, C, pad),
                    **t,
                    "delta_warm_us": t["warm_us"] - base[key]["warm_us"],
                    "delta_flushed_us": (t["flushed_us"]
                                         - base[key]["flushed_us"])}
            if mode in modes:
                emit({"probe": "gat_ablate", "graph": "pubmed_rcm",
                      "rows": op.n, "edges": op.E, "H": H, "C": C,
                      "rate": rate, "mode": mode, "bit": MODES[mode],
                      "walk": walk, "csr": csr_name,
                      "row_lengths": row_lengths(csr.row_ptr),
                      **line["compiled"], "matched": line["matched"],
                      "full_blocks_per_sm": target,
                      "bound_ms": bound, "bound_by": bound_by,
                      "finite": finite, "calls": args.calls, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
