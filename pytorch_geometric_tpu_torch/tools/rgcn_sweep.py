"""The packed RGCN on the full-graph MUTAG-RDF shape: layer 1's forward
and forward + backward, and (``--epoch``) one training epoch.

    python -m pytorch_geometric_tpu_torch.tools.rgcn_sweep [--epoch]
        [--calls 50] [--scale 1.0] [--device cuda]

Counterpart of ``tools/rgcn_sweep.py``. The graph is its ``build_graph``:
``Entities("MUTAG")`` at ``--scale`` (1.0, the published size), nodes
relabelled by RCM (``datasets/graphs.py:mutag_data(order="rcm")``).
Layer 1 is ``rgcn_fused_op(..., "embed")`` (a ``PackedRgcnSpmm`` over
the 24,576-row basis table, 46 relations, B = 30 bases of C = 16
channels), its inputs from ``numpy.random.default_rng(0)`` at 0.1
scale; its kernels are checked against their plain versions once (fp32,
1e-5), then the forward and forward + backward are timed beside
``bounds.py``'s bounds. ``--epoch`` adds one training epoch of
examples/rgcn.py's net (``models/entities.py:RGCN``, Adam 0.01) through
both layers' operators, captured in a CUDA graph as ``train_rgcn``
captures it and timed over ``--calls`` replays (eager on the CPU). One
JSON line a measurement.

The JAX script's ``--geoms`` (window x tile pack geometries) and
``--onehot`` have no counterpart: a CSR has no window or tile. ``--calls``
stands for its ``--K``.
"""

import argparse

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, timed, where)

R, B, C = 46, 30, 16


def build_graph(scale: float = 1.0, device="cuda"):
    """``(graph on device, host Data)``: the JAX ``build_graph``'s
    MUTAG-RDF, relabelled by RCM."""
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.datasets.graphs import mutag_data

    _, data = mutag_data("rcm", scale)
    return from_data(data, device=device), data


def epoch_us(step, dev, calls: int) -> dict:
    """One epoch of ``step``: on a card the epoch captured once (after one
    eager warm-up epoch, ``models/capture.py``) and ``calls`` replays timed
    with CUDA events; on the CPU the host's best-of wall time."""
    from pytorch_geometric_tpu_torch.models.capture import (
        capture_epoch, warm_up)
    from pytorch_geometric_tpu_torch.profiling import time_fn

    if dev.type != "cuda":
        return {"epoch_host_us": time_fn(step, iters=3) * 1e6}
    warm_up(step, dev)
    graph = capture_epoch(step, None, dev)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return {"epoch_device_us": start.elapsed_time(end) * 1e3 / calls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epoch", action="store_true",
                    help="also time one training epoch")
    ap.add_argument("--scale", type=float, default=1.0)
    add_device(ap)
    args = ap.parse_args(argv)
    info = where(args.device)
    from pytorch_geometric_tpu_torch.bounds import rgcn_bound
    from pytorch_geometric_tpu_torch.nn.conv.rgcn_conv import (
        rgcn_fused_op, rgcn_norm)
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    graph, _ = build_graph(args.scale, args.device)
    dev, N = graph.device, graph.num_nodes
    norm = rgcn_norm(graph, graph.edge_type, R)
    op = rgcn_fused_op(graph, graph.edge_type, R, "embed", in_channels=N,
                       norm=norm)
    rng = np.random.default_rng(0)
    xB, att = (torch.from_numpy((0.1 * rng.normal(size=shape)).astype(
        np.float32)).to(dev) for shape in ((N, B * C), (R, B)))
    g = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)).to(dev)
    fwd_err = check("packed_rgcn_fwd",
                    pr.packed_rgcn_fwd(op.fwd, op.send, xB, att),
                    pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w,
                                             xB, att), 1e-5)
    bwd_err = check("packed_rgcn_bwd",
                    pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w,
                                       op.bwd_pos, op.rel_ptr, xB, att, g),
                    pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w, xB,
                                             att, g), 1e-5)
    ins = [t.clone().requires_grad_() for t in (xB, att)]

    def fwd():
        with torch.no_grad():
            op(xB, att)

    def fwd_bwd():
        out = op(*ins)
        torch.autograd.grad((out * out).sum(), ins)

    bound_f = rgcn_bound(op, B, C, False)[0]
    bound_b = rgcn_bound(op, B, C, True)[0]
    records = []
    emit(records, {"tool": "rgcn_sweep", "layer": "conv1", "rows": N,
                   "edges": op.E, "R": R, "B": B, "C": C,
                   "fwd_err": fwd_err, "bwd_err": bwd_err,
                   **timed("fwd", fwd, dev, args.calls),
                   **timed("fwd_bwd", fwd_bwd, dev, args.calls),
                   "fwd_bound_us": bound_f * 1e3,
                   "fwd_bwd_bound_us": (bound_f + bound_b) * 1e3,
                   "calls": args.calls, **info})
    if args.epoch:
        from pytorch_geometric_tpu_torch.models.entities import (
            RGCN, create_rgcn_train_step)

        model = RGCN(N, R, 2, generator=torch.Generator().manual_seed(0))
        step, _ = create_rgcn_train_step(model.to(dev), graph, R)
        emit(records, {"tool": "rgcn_sweep", "epoch": "examples/rgcn.py",
                       "rows": N, "edges": op.E,
                       **epoch_us(lambda: step(None), dev, args.calls),
                       "calls": args.calls, **info})
    return records


if __name__ == "__main__":
    main()
