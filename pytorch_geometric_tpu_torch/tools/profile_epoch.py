"""Where a training epoch's time goes: ``torch.profiler`` over captured
epochs, the top device ops by time per epoch.

    python -m pytorch_geometric_tpu_torch.tools.profile_epoch
        [--which rgcn_mutag] [--epochs 30] [--reps 2] [--top 25]
        [--dataset Pubmed] [--scale 1.0] [--device cuda]

Counterpart of ``tools/profile_epoch.py`` (``print_op_stats`` over the
JAX profiler's xplane capture). ``--which``:

- ``gat_pubmed``: examples/gat.py's GAT (8 x 8 heads, AdamW 5e-3, weight
  decay 5e-4) on the RCM-reordered PubMed of ``gat_sweep.build_graph``,
  through one ``PackedFlashGat`` (its last layer divided, as the port's
  ``GAT`` does: the JAX script's ``raw_final`` has no counterpart);
- ``gcn_pubmed`` / ``gcn_pubmed_sorted``: the GCN (16 hidden, Adam
  0.01) of bench_common.py's full-graph PubMed row on the same graph,
  through ``spmm_csr`` (``backend="packed"``) or the receiver-sorted
  segment sum (``"sorted"``);
- ``rgcn_mutag``: examples/rgcn.py's net on ``rgcn_sweep.build_graph``'s
  MUTAG-RDF through the packed-RGCN kernels.

On a card the epoch is captured once in a CUDA graph as the trainers
capture it (``models/capture.py``; the JAX script profiles its scanned
program) and ``--epochs`` x ``--reps`` replays are traced after warm-up
(``profiling.profile_steps``, which ``chip_smoke.py``'s ``trace*`` phases
read the same way); on the CPU the eager epoch and the host operators'
self times. One JSON line: wall and busy ms an epoch, the idle share,
the port's launches an epoch and the ``--top`` ops. ``--dataset`` picks
the citation graph (the JAX script's is PubMed alone) and ``--scale``
MUTAG's size, for a check at a small size.
"""

import argparse

import torch

from pytorch_geometric_tpu_torch.tools.common import emit, where

WHICH = ("gat_pubmed", "rgcn_mutag", "gcn_pubmed", "gcn_pubmed_sorted")


def build_step(which: str, device, dataset: str = "Pubmed",
               scale: float = 1.0):
    """``(epoch step, its dropout generator or None, graph)`` of one
    ``--which`` configuration on ``device``."""
    from pytorch_geometric_tpu_torch.tools import gat_sweep, rgcn_sweep

    init = torch.Generator().manual_seed(0)
    if which == "rgcn_mutag":
        from pytorch_geometric_tpu_torch.models.entities import (
            RGCN, create_rgcn_train_step)

        graph, _ = rgcn_sweep.build_graph(scale, device)
        model = RGCN(graph.num_nodes, rgcn_sweep.R, 2, generator=init)
        step, _ = create_rgcn_train_step(model.to(graph.device), graph,
                                         rgcn_sweep.R)
        return step, None, graph
    from pytorch_geometric_tpu_torch.models.citation import (
        GAT, GCN, create_gat_train_step, create_gcn_train_step)

    graph = gat_sweep.build_graph(dataset, device)
    classes = int(graph.y.max()) + 1
    gen = torch.Generator(device=graph.device).manual_seed(0)
    if which == "gat_pubmed":
        model = GAT(graph.num_node_features, classes, generator=init)
        step, _ = create_gat_train_step(model.to(graph.device), graph,
                                        lr=5e-3, weight_decay=5e-4)
        return step, gen, graph
    model = GCN(graph.num_node_features, 16, classes, generator=init)
    backend = "sorted" if which == "gcn_pubmed_sorted" else "packed"
    step, _ = create_gcn_train_step(model.to(graph.device), graph,
                                    backend=backend)
    return step, gen, graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", default="rgcn_mutag", choices=WHICH)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dataset", default="Pubmed")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the host's "
                         "operators are profiled")
    args = ap.parse_args(argv)
    info = where(args.device)
    from pytorch_geometric_tpu_torch.models.capture import (
        capture_epoch, warm_up)
    from pytorch_geometric_tpu_torch.profiling import (
        profile_steps, trace_summary)

    step, gen, graph = build_step(args.which, args.device, args.dataset,
                                  args.scale)
    dev = graph.device
    if dev.type == "cuda":
        warm_up(lambda: step(gen), dev)
        run = capture_epoch(lambda: step(gen), gen, dev).replay
    else:
        run = lambda: step(gen)   # noqa: E731
    steps = args.epochs * args.reps
    kernels, wall_us = profile_steps(run, steps, dev)
    summary, _ = trace_summary(kernels, wall_us, steps, top=args.top,
                               where="device" if dev.type == "cuda"
                               else "host")
    records = []
    emit(records, {"tool": "profile_epoch", "which": args.which,
                   "rows": graph.num_nodes, "edges": graph.num_edges,
                   "epochs_traced": steps,
                   "captured": dev.type == "cuda", **summary, **info})
    return records


if __name__ == "__main__":
    main()
