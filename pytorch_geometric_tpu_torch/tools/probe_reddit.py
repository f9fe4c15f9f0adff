"""A Reddit-shaped SpMM on the card, stage by stage.

    python -m pytorch_geometric_tpu_torch.tools.probe_reddit
        [--n 232965] [--e 20000000] [--f 128] [--communities 200]
        [--block] [--window 1024] [--dense-threshold 1024] [--skip-bwd]
        [--calls 50] [--device cuda]

Counterpart of ``tools/probe_reddit.py``: the host generation of its
``gen_clustered`` graph (``datasets/graphs.py:gen_clustered``, draw for
draw; ``--communities`` communities, 90% of the edges inside one), x
and the edge weights from ``numpy.random.default_rng(1)``; then one
``SpmmOperator`` (``spmm_csr`` over a receiver-major CSR and its
transpose), its CSRs built on the host and uploaded as a stage of their
own, or with ``--block`` one ``BlockSpmm`` (dense ``--window`` blocks of
at least ``--dense-threshold`` edges, the remainder through
``spmm_csr``; built on the device). Its forward is checked once on the
first 2,000 rows against a plain sum (fp32 1e-5; ``--block`` 1e-2, its
dense products take bf16 x), then the forward and (unless
``--skip-bwd``) forward + backward are timed. One JSON line: each
stage's seconds (``gen_s``, ``build_s``, ``upload_s``), the times and
ns an edge.

The JAX script's ``--tile`` (the packed remainder's TPU tile) has no
counterpart: the remainder is a CSR.
"""

import argparse
import time

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, per_edge, timed, where)

#: Rows of the output checked against the plain sum.
CHECK_ROWS = 2000


def plain_rows(senders, receivers, w, x, rows: int):
    """``out[:rows]`` of ``out[r] = sum_e w_e x[s_e]`` in plain PyTorch on
    x's device, over the host edge arrays."""
    keep = np.flatnonzero(receivers < rows)
    dev = x.device
    s = torch.from_numpy(senders[keep]).to(dev)
    r = torch.from_numpy(receivers[keep]).to(dev)
    ww = torch.from_numpy(w[keep]).to(dev)
    out = torch.zeros((rows, x.shape[1]), dtype=torch.float32, device=dev)
    return out.index_add_(0, r, x[s] * ww[:, None])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        REDDIT_N, gen_clustered)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=REDDIT_N)
    ap.add_argument("--e", type=int, default=20_000_000)
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--communities", type=int, default=200)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--dense-threshold", type=int, default=1024)
    ap.add_argument("--block", action="store_true",
                    help="BlockSpmm (dense blocks + a CSR remainder)")
    ap.add_argument("--skip-bwd", action="store_true")
    add_device(ap)
    args = ap.parse_args(argv)
    info = where(args.device)
    dev = torch.device(args.device)
    from pytorch_geometric_tpu_torch.ops.block_spmm import BlockSpmm
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    t0 = time.perf_counter()
    senders, receivers, _ = gen_clustered(args.n, args.e, args.communities)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    x = rng.normal(size=(args.n, args.f)).astype(np.float32)
    w = rng.normal(size=args.e).astype(np.float32)
    line = {"tool": "probe_reddit", "n": args.n, "e": args.e, "f": args.f,
            "communities": args.communities, "gen_s": gen_s}
    if args.block:
        t0 = time.perf_counter()
        op = BlockSpmm(senders, receivers, args.n, w, window=args.window,
                       dense_threshold=args.dense_threshold, device=dev)
        fn, consts = op.bind()
        _sync(dev)
        line.update(operator="BlockSpmm", window=args.window,
                    dense_threshold=args.dense_threshold,
                    build_s=time.perf_counter() - t0,
                    dense_edge_frac=op.dense_edge_frac,
                    dense_blocks=op.num_dense_blocks,
                    remainder_edges=op.sparse_edges)

        def apply(xx):
            return fn(consts, xx)
        tol = 1e-2
    else:
        t0 = time.perf_counter()
        op = SpmmOperator(senders, receivers, args.n, device="cpu")
        line.update(operator="SpmmOperator",
                    build_s=time.perf_counter() - t0)
        apply, tol = None, 1e-5
    t0 = time.perf_counter()
    if apply is None:
        apply = op.to(dev).bind(w)
    xd = torch.from_numpy(x).to(dev)
    _sync(dev)
    line["upload_s"] = time.perf_counter() - t0
    rows = min(CHECK_ROWS, args.n)
    with torch.no_grad():
        line["fwd_err"] = check(f"{line['operator']} forward",
                                apply(xd)[:rows],
                                plain_rows(senders, receivers, w, xd, rows),
                                tol)

    def fwd():
        with torch.no_grad():
            apply(xd)

    line.update(timed("fwd", fwd, dev, args.calls))
    if not args.skip_bwd:
        xg = xd.clone().requires_grad_()

        def fwd_bwd():
            out = apply(xg)
            torch.autograd.grad((out * out).sum(), xg)

        line.update(timed("fwd_bwd", fwd_bwd, dev, args.calls))
    records = []
    emit(records, {**per_edge(line, args.e), "calls": args.calls, **info})
    return records


if __name__ == "__main__":
    main()
