"""``BlockSpmm`` on an adversarial sparse tail (Zipf senders, uniform
receivers): ns an edge, swept over the window.

    python -m pytorch_geometric_tpu_torch.tools.adv_asym_probe
        [--n 232965] [--e 8000000] [--f 128] [--windows 1024,2048,4096]
        [--calls 50] [--device cuda]

Counterpart of ``tools/adv_asym_probe.py``: the senders' ranks Zipf(1.5)
over a random permutation of the nodes, uniform receivers, the weights
and x, all drawn from ``numpy.random.default_rng(7)`` as it draws them
(:func:`draw`). Per window, one ``BlockSpmm`` (dense blocks of at least
1024 edges, as there; the remainder through ``spmm_csr``) checked once
on the first 2,000 rows against a plain sum (1e-2: its dense products
take bf16 x), then its forward timed. One JSON line a window: build
seconds, the time, ns an edge, dense blocks and remainder edges.

The JAX script sweeps (source window, destination window, tile) of its
packed TPU remainder; the source window and the tile have no
counterpart (the remainder is a CSR), so the port sweeps the window
alone.
"""

import argparse
import time

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, per_edge, timed, where)
from pytorch_geometric_tpu_torch.tools.probe_reddit import (
    CHECK_ROWS, plain_rows)


def draw(n: int, e: int, f: int):
    """``(senders, receivers, weights, x)``, the JAX script's draws."""
    rng = np.random.default_rng(7)
    ranks = rng.zipf(1.5, size=e).astype(np.int64) % n
    perm = rng.permutation(n)
    senders = perm[ranks]
    receivers = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return senders, receivers, w, x


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import REDDIT_N

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=REDDIT_N)
    ap.add_argument("--e", type=int, default=8_000_000)
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--windows", default="1024,2048,4096")
    add_device(ap)
    args = ap.parse_args(argv)
    info = where(args.device)
    dev = torch.device(args.device)
    from pytorch_geometric_tpu_torch.ops.block_spmm import BlockSpmm

    senders, receivers, w, x = draw(args.n, args.e, args.f)
    x = torch.from_numpy(x).to(dev)
    rows = min(CHECK_ROWS, args.n)
    want = plain_rows(senders, receivers, w, x, rows)
    records = []
    for window in (int(v) for v in args.windows.split(",")):
        t0 = time.perf_counter()
        op = BlockSpmm(senders, receivers, args.n, w, window=window,
                       dense_threshold=1024, device=dev)
        fn, consts = op.bind()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        with torch.no_grad():
            err = check(f"BlockSpmm window {window}", fn(consts, x)[:rows],
                        want, 1e-2)

        def fwd():
            with torch.no_grad():
                fn(consts, x)

        line = {"tool": "adv_asym_probe", "window": window, "n": args.n,
                "e": args.e, "f": args.f, "build_s": build_s,
                "fwd_err": err, **timed("fwd", fwd, dev, args.calls),
                "dense_blocks": op.num_dense_blocks,
                "remainder_edges": op.sparse_edges}
        per_edge(line, args.e)
        emit(records, {**line, "calls": args.calls, **info})
        del op, fn, consts
    return records


if __name__ == "__main__":
    main()
