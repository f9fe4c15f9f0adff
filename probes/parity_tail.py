"""Card-against-CPU gates of ``chip_smoke.py`` over fixed hash seeds.

    python3 probes/parity_tail.py [--gate driver_gat|infomax] [--seeds 0-9]
                                  [--root DIR ...]

Two gates of ``chip_smoke.py`` hold a model after a few Adam steps on the
card to the same steps on the CPU (the kernels' plain versions):
``slice_driver_gat`` the research driver's GAT logits after three epochs
of ``train_part`` (``DRIVER_PARITY_TOL["GAT"]``, 1e-3 of the largest CPU
magnitude), ``slice_infomax`` examples/infomax.py's embeddings after
three steps (``INFOMAX_PARITY_TOL``, 1e-4). The synthetic Cora draws its
graph from the process's string hash (``datasets/synthetic.py``), so a
gate meets another graph in every process. This probe runs the gate's
comparison (the tree's own ``chip_smoke._parity`` over its steps
function: ``driver_steps_logits`` at the driver's widths, as
``training_net`` draws them, or ``infomax_steps_z``) in one process per
``PYTHONHASHSEED`` of ``--seeds`` (``0-9``, or a comma list), for each
tree of ``--root`` (default: this checkout; another checkout or an
unpacked archive of an earlier commit compares two trees in one run). A
seed whose gap passes the gate prints its three-step gap; one that fails
also prints the gaps after one and two steps and the first step at which
card and CPU part by more than 1e-5.

Prints one JSON line a (tree, seed) and one summary line a tree (failure
rate, largest gap), each with the card's name and power limit. Loosens
nothing: the gate and its tolerance are the tree's own. Exits non-zero
without a card.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import card, emit, require_card  # noqa: E402

GATES = ("driver_gat", "infomax")
#: What one process runs, in the tree's root: the gate's comparison after
#: each asked number of steps (epochs of the driver), one JSON line.
CHILD = r"""
import functools, json, sys
import torch
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs

if sys.argv[1] == "driver_gat":
    from pytorch_geometric_tpu_torch.research import driver
    from pytorch_geometric_tpu_torch.research.pruning import (
        contraction_layer_coefficients)

    _, graph = driver.load_citation_dataset("Cora", device="cpu")
    widths = contraction_layer_coefficients(graph.num_node_features, 2, 0.5,
                                            seed=0)
    tol = cs.DRIVER_PARITY_TOL["GAT"]
    steps_fn = lambda k: functools.partial(
        cs.driver_steps_logits, "GAT", widths=widths, epochs=k)
else:
    tol = cs.INFOMAX_PARITY_TOL
    steps_fn = lambda k: functools.partial(cs.infomax_steps_z, steps=k)
gaps = {}
for k in [int(e) for e in sys.argv[2].split(",")]:
    gaps[k] = cs._parity(steps_fn(k))[0]
    if k == 3 and gaps[3] <= tol:
        break
print(json.dumps({"tol": tol, "gaps": gaps}))
"""


def parse_seeds(text):
    """``"0-9"`` or ``"0,3,7"``: the hash seeds."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def run_seed(root, gate, seed):
    """The child's result for one gate and hash seed in ``root``: three
    steps, and one and two where three fail the gate."""
    env = {**os.environ, "PYTHONHASHSEED": str(seed),
           "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, gate, "3,1,2"],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{gate} seed {seed} in {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    gaps = {int(k): v for k, v in res["gaps"].items()}
    parted = [k for k in sorted(gaps) if gaps[k] > 1e-5]
    return {"gate": gate, "seed": seed, "tol": res["tol"],
            "gap_steps": gaps, "passes": gaps[3] <= res["tol"],
            "first_step_over_1e-5": (parted[0] if parted and len(gaps) == 3
                                     else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", default="driver_gat", choices=GATES)
    ap.add_argument("--seeds", default="0-9")
    ap.add_argument("--root", action="append", default=None,
                    help="a tree to run (repeat for several; default this "
                         "checkout)")
    args = ap.parse_args(argv)
    if not require_card("parity_tail"):
        return 1
    smi = card()
    seeds = parse_seeds(args.seeds)
    for root in args.root or [str(REPO)]:
        root = str(Path(root).resolve())
        rows = []
        for seed in seeds:
            row = {"probe": "parity_tail", "root": root,
                   **run_seed(root, args.gate, seed), "card": smi}
            emit(row)
            rows.append(row)
        fails = [r["seed"] for r in rows if not r["passes"]]
        emit({"probe": "parity_tail", "gate": args.gate, "root": root,
              "seeds": seeds, "failed_seeds": fails,
              "failure_rate": len(fails) / len(rows),
              "largest_gap": max(r["gap_steps"][3] for r in rows),
              "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
