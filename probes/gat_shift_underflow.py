"""Rows that the packed GAT's softmax shift would underflow, over the
research driver's GAT run, on one NVIDIA GPU or on the CPU.

    python3 probes/gat_shift_underflow.py [--device cpu] [--epochs 20]
                                          [--fine-tune 60]

Runs ``research/driver.py:training_net("Cora", "GAT")`` at the driver's
defaults and ``chip_smoke.py``'s ``slice_driver_gat`` epochs (20 + 60)
in a temporary directory, with every packed-GAT forward watched. Per
call: the rows that have edges; those whose den the call leaves below 1
(the per-receiver shift puts each row's largest logit at exp(0) = 1, so
none may); and those whose den the JAX operator's global shift, one max
of s a head over all rows, underflows below 1e-16 (the plain forward at
that shift, on the call's own inputs), where that operator outputs 0.
One JSON line: the calls, the calls and rows the global shift would have
underflowed, the rows below 1 now, and the phase-2 training loss of each
epoch with its first, last and largest value and the epochs that end
above the first (``slice_driver_gat``'s gate reads the last of them).
The synthetic Cora follows ``PYTHONHASHSEED`` (``datasets/synthetic.py``),
so set it to repeat a run's graph.
"""

import argparse
import glob
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def watch(pg, stats):
    """``pg.packed_gat_fwd`` wrapped to count, per call, the rows with
    edges, those below den 1 and those the global shift underflows, into
    ``stats``; returns the original to restore."""
    original = pg.packed_gat_fwd

    def watched(csr, d, s, h, seed, rate=0.0, slope=0.2):
        out, m = original(csr, d, s, h, seed, rate, slope)
        n, H = d.shape
        HC = h.shape[1]
        rows = (csr.row_ptr[1:] - csr.row_ptr[:-1]) > 0
        den = out[:, HC:][rows]
        old = pg.packed_gat_fwd_plain(
            csr, d, s, h, s.amax(0).expand(n, H).contiguous(), seed, rate,
            slope)[:, HC:][rows]
        under = int((old < 1e-16).any(dim=1).sum())
        stats["calls"] += 1
        stats["rows_with_edges"] = int(rows.sum())
        stats["rows_den_below_1"] += int((den < 1).any(dim=1).sum())
        stats["global_shift_calls_underflowing"] += under > 0
        stats["global_shift_rows_underflowing"] += under
        stats["global_shift_max_row_share"] = max(
            stats["global_shift_max_row_share"], under / int(rows.sum()))
        return out, m

    watched.launches = original.launches
    pg.packed_gat_fwd = watched
    return original


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--fine-tune", type=int, default=60)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("gat_shift_underflow: CUDA is not available (pass --device "
              "cpu for the CPU)", file=sys.stderr)
        return 1
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg
    from pytorch_geometric_tpu_torch.research import driver

    stats = {"calls": 0, "rows_with_edges": 0, "rows_den_below_1": 0,
             "global_shift_calls_underflowing": 0,
             "global_shift_rows_underflowing": 0,
             "global_shift_max_row_share": 0.0}
    original = watch(pg, stats)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            (res,) = driver.training_net(
                "Cora", "GAT", epochs=args.epochs,
                fine_tune_epochs=args.fine_tune, results_dir=f"{tmp}/R",
                ckpt_dir=f"{tmp}/c", device=args.device)
            (path,) = glob.glob(f"{tmp}/R/CoraConvergence/"
                                "TrainConvergence-*.npy")
            curve = np.load(path).astype(float)
    finally:
        pg.packed_gat_fwd = original
    line = {"probe": "gat_shift_underflow", "device": args.device,
            "epochs": [args.epochs, args.fine_tune],
            "widths": res["widths"], "pruned_widths": res["new_widths"],
            **stats, "phase2_losses": curve.round(4).tolist(),
            "phase2_first": curve[0], "phase2_last": curve[-1],
            "phase2_max": curve.max(),
            "phase2_epochs_above_first": int((curve[1:] > curve[0]).sum()),
            "ln_classes": math.log(7)}
    if args.device != "cpu":
        from probes.common import card

        line["card"] = card()
    print(json.dumps(line), flush=True)
    return 0 if stats["rows_den_below_1"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
