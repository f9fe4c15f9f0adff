"""Card-against-CPU gates of ``chip_smoke.py`` over fixed hash seeds.

    python3 probes/parity_tail.py [--gate all|GATE[,GATE...]] [--seeds 0-39]
                                  [--jobs 4] [--root DIR ...]

Six gates of ``chip_smoke.py`` hold a path after three optimizer steps
on the card to the same steps on the CPU (the kernels' plain versions):
``infomax`` (``slice_infomax``, the embeddings), ``gae`` and ``vgae``
(``slice_autoencoder``), ``topk`` (``slice_topk``, the logits),
``driver_gcn`` and ``driver_gat`` (``slice_driver``, ``slice_driver_gat``:
the logits after three epochs of ``train_part``).
The synthetic Cora and ENZYMES draw their graphs from the process's
string hash (``datasets/synthetic.py``), so a gate meets other graphs in
every process. For each hash seed of ``--seeds`` (``0-39``, or a comma
list) this probe starts one process in the tree (``--root``, default this
checkout; a tree whose ``chip_smoke.py`` has ``step_gate``), ``--jobs`` at
a time, which runs every gate of ``--gate`` through the tree's own
functions (``chip_smoke.step_gate``, ``_parity``, ``_step_gate``):

- the old gate: three steps of the path's own Adam (AdamW in the driver),
  the output's gap against the gate's tolerance;
- what happens at the Adam run's first step: the count of gradient
  elements whose signs differ between card and CPU, the parameters they
  sit in, their largest magnitude relative to the largest CPU gradient,
  the largest gap of the step-1 gradients relative to that gradient, and
  the largest parameter gap after the three steps on those elements and
  on all others (the suspect of ROADMAP Queue C 1: Adam moves each weight
  by about ``lr sign(g)``, so a flipped sign moves it ``2 lr`` apart);
- the gate as the tree holds it (``chip_smoke._step_gate``): three SGD
  steps (``GATE_SGD_LR``), the CPU taking the card's branch at the
  path's ReLU and PReLU kinks (``KinkRoutes``; the elements it moved
  counted), the output's gap and the step-1 gradients' gap against the
  same tolerance, and the largest parameter move of the SGD and of the
  Adam steps (the SGD steps' must be at least the Adam steps').

Prints one JSON line a (tree, seed, gate) and one summary line a (tree,
gate): the gate's failures and the old Adam gate's, each with its rate,
and the largest gaps and moves, with the card's name and power limit.
Loosens nothing: the gates and their tolerances are the tree's own.
Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from probes.common import card, emit, require_card  # noqa: E402

GATES = ("infomax", "gae", "vgae", "topk", "driver_gcn", "driver_gat")
#: What one process runs, in the tree's root: every asked gate, the Adam
#: steps with their step-1 diagnosis and the SGD steps, one JSON line.
CHILD = r"""
import functools, json, sys
import torch
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(int(sys.argv[2]))
import chip_smoke as cs


def step1(card, cpu):
    grads, cpu_grads = card.gate_grads, cpu.gate_grads
    params = dict(card.named_parameters())
    cpu_params = dict(cpu.named_parameters())
    scale = max(float(g.abs().max()) for g in cpu_grads.values())
    flips, where, largest, on, off = 0, {}, 0.0, 0.0, 0.0
    for name, g in cpu_grads.items():
        flip = torch.sign(grads[name].cpu()) != torch.sign(g)
        gap = (params[name].detach().cpu() - cpu_params[name].detach()).abs()
        if flip.any():
            flips += int(flip.sum())
            where[name] = int(flip.sum())
            largest = max(largest, float(g[flip].abs().max()))
            on = max(on, float(gap[flip].max()))
        if (~flip).any():
            off = max(off, float(gap[~flip].max()))
    return {"sign_flips": flips, "flipped_in": where,
            "largest_flipped_grad_rel": largest / scale,
            "grads_rel_gap": cs.grads_gap(card, cpu),
            "param_gap_on_flips": on, "param_gap_elsewhere": off}


out = {}
for gate in sys.argv[1].split(","):
    steps, tol, _ = cs.step_gate(gate)
    adam = {}
    adam_gap = cs._parity(functools.partial(steps, optimizer="adam"),
                          adam)[0]
    report = cs._step_gate(steps, tol, "out", [])
    out[gate] = {"tol": tol, "adam_gap": adam_gap,
                 "adam_step1": step1(adam["card"][1], adam["cpu"][1]),
                 "sgd_lr": cs.GATE_SGD_LR[gate],
                 "sgd_gap": report["out_cuda_vs_cpu_rel_err"],
                 "grads_gap": report["step1_grads_cuda_vs_cpu_rel_err"],
                 "kinks_routed": report["kinks_routed"],
                 "adam_move": report["adam_largest_move"],
                 "sgd_move": report["sgd_largest_move"]}
print(json.dumps(out))
"""


def parse_seeds(text):
    """``"0-9"`` or ``"0,3,7"``: the hash seeds."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def parse_gates(text):
    """``"all"`` or a comma list of :data:`GATES`."""
    gates = list(GATES) if text == "all" else text.split(",")
    unknown = [g for g in gates if g not in GATES]
    if unknown:
        raise argparse.ArgumentTypeError(f"unknown gates {unknown}: "
                                         f"{', '.join(GATES)} or all")
    return gates


def run_seed(root, gates, seed, threads=1):
    """One process for a hash seed in ``root``: a row a gate, with
    ``passes`` (the SGD output and the step-1 gradients within the
    tolerance, the SGD steps moving at least as far as the Adam steps)
    and ``adam_passes`` (the old gate)."""
    env = {**os.environ, "PYTHONHASHSEED": str(seed),
           "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", CHILD, ",".join(gates),
                           str(threads)],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{gates} seed {seed} in {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = []
    for gate in gates:
        r = res[gate]
        rows.append({"gate": gate, "seed": seed, **r,
                     "passes": r["sgd_gap"] <= r["tol"]
                     and r["grads_gap"] <= r["tol"]
                     and r["sgd_move"] >= r["adam_move"],
                     "adam_passes": r["adam_gap"] <= r["tol"]})
    return rows


def summary(rows):
    """A gate's line over its seeds: the failures of the gate and of the
    old Adam gate, the largest gaps and the moves."""
    fails = [r["seed"] for r in rows if not r["passes"]]
    adam_fails = [r["seed"] for r in rows if not r["adam_passes"]]
    return {"seeds": [r["seed"] for r in rows], "tol": rows[0]["tol"],
            "failed_seeds": fails, "failure_rate": len(fails) / len(rows),
            "adam_failed_seeds": adam_fails,
            "adam_failure_rate": len(adam_fails) / len(rows),
            "largest_sgd_gap": max(r["sgd_gap"] for r in rows),
            "largest_grads_gap": max(r["grads_gap"] for r in rows),
            "largest_adam_gap": max(r["adam_gap"] for r in rows),
            "smallest_sgd_over_adam_move": min(r["sgd_move"] / r["adam_move"]
                                               for r in rows)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", default="all", type=parse_gates)
    ap.add_argument("--seeds", default="0-39")
    ap.add_argument("--jobs", type=int, default=4,
                    help="processes at a time (each gets its share of the "
                         "CPU's threads)")
    ap.add_argument("--root", action="append", default=None,
                    help="a tree to run (repeat for several; default this "
                         "checkout)")
    args = ap.parse_args(argv)
    if not require_card("parity_tail"):
        return 1
    smi = card()
    seeds = parse_seeds(args.seeds)
    threads = max(1, (os.cpu_count() or 1) // args.jobs)
    for root in args.root or [str(REPO)]:
        root = str(Path(root).resolve())
        with ThreadPoolExecutor(args.jobs) as pool:
            by_seed = list(pool.map(
                lambda s: run_seed(root, args.gate, s, threads), seeds))
        for gate_rows in zip(*by_seed):
            for row in gate_rows:
                emit({"probe": "parity_tail", "root": root, **row,
                      "card": smi})
            emit({"probe": "parity_tail", "gate": gate_rows[0]["gate"],
                  "root": root, **summary(list(gate_rows)), "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
