"""``BlockSpmm``'s ``dense_threshold`` swept at the full Reddit edge
count: forward time, dense blocks and remainder edges a threshold.

    python -m pytorch_geometric_tpu_torch.tools.reddit_threshold_probe
        [--n 232965] [--e 114615892] [--f 128] [--communities 200]
        [--thresholds 512,768,1024,2048] [--calls 20] [--device cuda]

Counterpart of ``tools/reddit_threshold_probe.py``: bench_scale.py's
``gen_clustered`` graph (``datasets/graphs.py:gen_clustered``, draw for
draw), weights 1, x from ``numpy.random.default_rng(1)``. First one line
with the (1024, 1024) buckets' histogram by edge count, [buckets, edges]
a bin; then, per threshold, one ``BlockStructure`` + ``BlockSpmm``
(window 1024: the buckets of at least that many edges as dense blocks,
the rest through ``spmm_csr``) checked once on the first 2,000 rows
against a plain sum (1e-2: the dense products take bf16 x), and one line
with its build seconds, forward time, ns an edge, dense blocks, dense
edge share, remainder edges and the histogram of the remainder's
buckets (those below the threshold).

The JAX script's ``sparse_tile`` (the packed remainder's TPU tile) has
no counterpart: the remainder is a CSR.
"""

import argparse
import time

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, per_edge, timed, where)
from pytorch_geometric_tpu_torch.tools.probe_reddit import (
    CHECK_ROWS, plain_rows)

WINDOW = 1024
#: The histogram's bins of bucket sizes, [lo, hi) edges.
BINS = ((1, 256), (256, 512), (512, 768), (768, 1024), (1024, 4096),
        (4096, 1 << 30))


def bucket_counts(senders, receivers, n: int, window: int = WINDOW):
    """Edges in each nonempty (receiver window, sender window) bucket."""
    nw = -(-n // window)
    key = (receivers // window).astype(np.int64) * nw + senders // window
    counts = np.bincount(key, minlength=nw * nw)
    return counts[counts > 0]


def histogram(sizes) -> dict:
    """``{"[lo,hi)": [buckets, edges]}`` over :data:`BINS`."""
    out = {}
    for lo, hi in BINS:
        sel = (sizes >= lo) & (sizes < hi)
        out[f"[{lo},{hi})"] = [int(sel.sum()), int(sizes[sel].sum())]
    return out


def main(argv=None):
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        REDDIT_E, REDDIT_N, gen_clustered)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=REDDIT_N)
    ap.add_argument("--e", type=int, default=REDDIT_E)
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--communities", type=int, default=200)
    ap.add_argument("--thresholds", default="512,768,1024,2048")
    add_device(ap, calls=20)
    args = ap.parse_args(argv)
    info = where(args.device)
    dev = torch.device(args.device)
    from pytorch_geometric_tpu_torch.ops.block_spmm import (
        BlockSpmm, BlockStructure)

    t0 = time.perf_counter()
    senders, receivers, _ = gen_clustered(args.n, args.e, args.communities)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    w = np.ones(args.e, np.float32)
    x = torch.from_numpy(rng.normal(size=(args.n, args.f)).astype(
        np.float32)).to(dev)
    sizes = bucket_counts(senders, receivers, args.n)
    records = []
    emit(records, {"tool": "reddit_threshold_probe", "n": args.n,
                   "e": args.e, "window": WINDOW, "gen_s": gen_s,
                   "bucket_histogram": histogram(sizes), **info})
    rows = min(CHECK_ROWS, args.n)
    want = plain_rows(senders, receivers, w, x, rows)
    for thresh in (int(v) for v in args.thresholds.split(",")):
        t0 = time.perf_counter()
        st = BlockStructure(senders, receivers, args.n, window=WINDOW,
                            dense_threshold=thresh, device=dev)
        op = BlockSpmm(senders, receivers, args.n, w, structure=st)
        fn, consts = op.bind()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        with torch.no_grad():
            err = check(f"BlockSpmm threshold {thresh}",
                        fn(consts, x)[:rows], want, 1e-2)

        def fwd():
            with torch.no_grad():
                fn(consts, x)

        line = {"tool": "reddit_threshold_probe", "threshold": thresh,
                "f": args.f, "build_s": build_s, "fwd_err": err,
                **timed("fwd", fwd, dev, args.calls),
                "dense_blocks": st.num_dense_blocks,
                "dense_edge_frac": st.dense_edge_frac,
                "remainder_edges": st.sparse_edges,
                "remainder_histogram": histogram(sizes[sizes < thresh])}
        per_edge(line, args.e)
        emit(records, {**line, "calls": args.calls, **info})
        del st, op, fn, consts
    return records


if __name__ == "__main__":
    main()
