"""``spmm_csr`` on 10 M uniform edges (the scattered sparse tail of a
Reddit-sized graph): ns an edge, swept over the feature width.

    python -m pytorch_geometric_tpu_torch.tools.sparse_tail_probe
        [--n 232965] [--e 10000000] [--f 128[,32,...]] [--calls 50]
        [--device cuda]

Counterpart of ``tools/sparse_tail_probe.py``: senders, receivers and
the edge weights drawn from ``numpy.random.default_rng(3)`` as it draws
them, then x for each width of ``--f`` in turn (the first width's x is
the JAX script's). One ``SpmmOperator`` over the edges; at each width
its forward is checked once on the first 2,000 rows against a plain sum
(fp32, 1e-5), then timed. One JSON line a width: the device µs, ns an
edge and the bound (``bounds.py:spmm_bound``).

The JAX script sweeps ``--points`` of (window, tile) pack geometries,
whose buckets its TPU kernel pays for one by one; a CSR has none, so
the port sweeps ``--f`` instead.
"""

import argparse

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, per_edge, timed, where)
from pytorch_geometric_tpu_torch.tools.probe_reddit import (
    CHECK_ROWS, plain_rows)


def draw_edges(n: int, e: int):
    """``(rng, senders, receivers, weights)``: the JAX script's first
    draws; x comes next from ``rng``."""
    rng = np.random.default_rng(3)
    senders = rng.integers(0, n, e)
    receivers = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    return rng, senders, receivers, w


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import REDDIT_N

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=REDDIT_N)
    ap.add_argument("--e", type=int, default=10_000_000)
    ap.add_argument("--f", default="128",
                    help="comma-separated feature widths")
    add_device(ap)
    args = ap.parse_args(argv)
    info = where(args.device)
    dev = torch.device(args.device)
    from pytorch_geometric_tpu_torch.bounds import spmm_bound
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    rng, senders, receivers, w = draw_edges(args.n, args.e)
    op = SpmmOperator(senders, receivers, args.n, device=dev)
    apply = op.bind(w)
    rows = min(CHECK_ROWS, args.n)
    records = []
    for f in (int(v) for v in args.f.split(",")):
        x = torch.from_numpy(rng.normal(size=(args.n, f)).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            err = check(f"spmm_csr F={f}", apply(x)[:rows],
                        plain_rows(senders, receivers, w, x, rows), 1e-5)

        def fwd():
            with torch.no_grad():
                apply(x)

        line = {"tool": "sparse_tail_probe", "n": args.n, "e": args.e,
                "f": f, "fwd_err": err, **timed("fwd", fwd, dev, args.calls)}
        per_edge(line, args.e)
        line["bound_us"] = spmm_bound(op.fwd, f, 4)[0] * 1e3
        emit(records, {**line, "calls": args.calls, **info})
    return records


if __name__ == "__main__":
    main()
