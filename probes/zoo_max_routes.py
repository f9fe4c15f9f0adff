"""The zoo's card-against-CPU comparison of a conv (``chip_smoke.py``'s
``zoo`` phase runs it for each conv), and how often the max aggregations
(EdgeConv, PointConv) order two near-equal messages one way on the card
and the other on the CPU, over draws of the synthetic Cora, on one
NVIDIA GPU or on the CPU.

    python3 probes/zoo_max_routes.py [--device cpu] [--graphs 100]
                                     [--first 0]

A max sends its cotangent to the entry that holds it, so where two
messages of a segment lie a rounding apart, the card's and the CPU's
backward may feed different edges. :func:`compare` therefore runs a max
aggregation a third time on the CPU, with each max's backward routed
through the card's maxima (:class:`MaxRoutes`), and reports the
gradients' errors against that run beside the plain ones.

The synthetic Cora's seed is ``hash("cora") % 2**16`` (``PYTHONHASHSEED``
picks it, ``datasets/synthetic.py``); the scan sets that hash to
``first``, ``first + 1``, ... in turn and compares EdgeConv and PointConv
at the zoo's widths (1433 -> 16; weights from seed 0) on each graph. One
JSON line a graph and conv: the hash, the (entry, channel) routes of the
max that differ between the devices, the plain backward's errors, those
against the CPU's backward routed through the card's maxima, and whether
each gate (1e-4) passes. The last line sums them.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOL = 1e-4


def rel(got, want):
    """Largest error relative to the largest magnitude of ``want``."""
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


class MaxRoutes:
    """Patches ``ops/segment.py:_segment_extreme`` while it is entered.
    Every floating ``amax`` appends ``(data, weights)`` to ``records``:
    ``weights`` (E, C) is where the backward sends each segment's
    cotangent, split evenly among the entries equal to its max, as
    ``scatter_reduce``'s backward does. Given ``route`` (another run's
    records of the same calls, in order), each max keeps its own values
    but its backward follows that run's weights."""

    def __init__(self, route=None):
        self.records, self.route = [], route

    def __enter__(self):
        from pytorch_geometric_tpu_torch.ops import segment

        inner = self.inner = segment._segment_extreme

        def extreme(data, segment_ids, num_segments, reduce):
            out = inner(data, segment_ids, num_segments, reduce)
            if reduce != "amax" or not data.is_floating_point():
                return out
            ids = segment_ids.long()
            d = data.detach()
            sel = (d == out.detach()[ids]).to(d.dtype)
            cnt = torch.zeros_like(out).index_add_(0, ids, sel)
            w = sel / cnt[ids].clamp_min(1.0)
            self.records.append((d, w))
            if self.route is None:
                return out
            routed = self.route[len(self.records) - 1][1].to(d.device)
            # data - data.detach() is 0 for the finite entries (padding
            # messages too), so the values stay the max's own
            return out.detach() + torch.zeros_like(out).index_add_(
                0, ids, routed * (data - d))

        segment._segment_extreme = extreme
        return self

    def __exit__(self, *exc):
        from pytorch_geometric_tpu_torch.ops import segment

        segment._segment_extreme = self.inner


def route_errors(card, cpu):
    """``(messages' largest error relative to their largest magnitude,
    (entry, channel) weights that differ)`` of two devices' records of
    the same max aggregations; the padding messages (at the dtype's
    extreme) are left out."""
    err, differ = 0.0, 0
    for (d, w), (ref, ref_w) in zip(card, cpu):
        d, w = d.cpu(), w.cpu()
        real = ref.abs() < torch.finfo(ref.dtype).max
        err = max(err, rel(d[real], ref[real]))
        differ += int((w != ref_w).sum())
    return err, differ


def compare(conv, call, ops_of, x, gen, device="cuda", max_aggr=False):
    """One forward and one backward of ``conv`` (on the CPU; left there)
    through ``call(module, x, device, ops)`` on ``device`` with
    ``ops_of(device)``, against the same on the CPU with no operators,
    from the same parameters, input ``x`` and cotangent (drawn from
    ``gen``): the output's and the input gradient's errors relative to
    the largest reference magnitude, the parameters' relative to the
    largest reference gradient, and the launches on ``device``. With
    ``max_aggr``, also the messages' errors, the routes that differ and
    the gradients' errors against the CPU's backward routed through the
    card's maxima; ``gate`` lists the errors held to 1e-4 (the routed
    ones in place of the plain gradients')."""
    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    runs = [(device, copy.deepcopy(conv).to(device), ops_of),
            ("cpu", copy.deepcopy(conv), lambda dev: {})]
    if max_aggr:
        runs.append(("cpu", copy.deepcopy(conv), lambda dev: {}))
    results, ct, records = [], None, []
    for dev, m, ops_of_dev in runs:
        xi = x.to(dev, copy=True).requires_grad_(True)
        ops = ops_of_dev(dev)
        before = launch_counts()
        with MaxRoutes(records[0] if len(records) == 2 else None) as routes:
            out = call(m, xi, dev, ops)
            if ct is None:
                ct = torch.randn(out.shape, generator=gen)
            (out * ct.to(dev)).sum().backward()
        records.append(routes.records)
        launched = {k: v - before[k] for k, v in launch_counts().items()
                    if v != before[k]}
        results.append((out.detach().cpu(), xi.grad.cpu(),
                        {n: p.grad.cpu() for n, p in m.named_parameters()},
                        launched))
    (out, dx, grads, launched), (ref, ref_dx, ref_grads, _) = results[:2]

    def grad_errors(ref_dx, ref_grads):
        scale = max([float(v.abs().max()) for v in ref_grads.values()] + [0])
        return rel(dx, ref_dx), max(
            [float((grads[n] - v).abs().max()) / max(scale, 1e-30)
             for n, v in ref_grads.items()] + [0.0])

    dx_err, param_err = grad_errors(ref_dx, ref_grads)
    res = {"out": out, "launches": launched, "out_rel_err": rel(out, ref),
           "dx_rel_err": dx_err, "param_grad_rel_err": param_err}
    gate = [res["out_rel_err"], dx_err, param_err]
    if max_aggr:
        msg_err, differ = route_errors(records[0], records[1])
        routed = grad_errors(*results[2][1:3])
        res.update({"max_calls": len(records[0]),
                    "messages_rel_err": msg_err,
                    "max_routes_differ": differ,
                    "dx_rel_err_card_routes": routed[0],
                    "param_grad_rel_err_card_routes": routed[1]})
        gate = [res["out_rel_err"], msg_err, *routed]
        if not records[0] or len(records[0]) != len(records[1]):
            gate.append(float("inf"))
    res["gate"] = gate
    return res


def max_convs(f, c, gen):
    """The zoo's max aggregations at width ``f`` -> ``c``: ``(name,
    conv, call)``; PointConv on positions drawn from seed 0, over the
    graph's real edges."""
    from pytorch_geometric_tpu_torch.nn import conv as tc
    from pytorch_geometric_tpu_torch.nn.layers import Dense

    def edge_call(g):
        return lambda m, x, dev, ops: m(g[dev], x)

    def point_call(g):
        def call(m, x, dev, ops):
            gg = g[dev]
            pos = torch.from_numpy(np.random.default_rng(0).normal(
                size=(gg.num_nodes, 3)).astype(np.float32)).to(dev)
            keep = gg.real_edge_mask()
            return m(x, pos, gg.senders[keep], gg.receivers[keep],
                     gg.num_nodes)
        return call

    return [("EdgeConv", tc.EdgeConv(Dense(2 * f, c, generator=gen)),
             edge_call),
            ("PointConv", tc.PointConv(Dense(f + 3, c, generator=gen),
                                       Dense(c, c, generator=gen)),
             point_call)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--graphs", type=int, default=100)
    p.add_argument("--first", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("zoo_max_routes: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False

    from pytorch_geometric_tpu_torch.datasets import synthetic
    from pytorch_geometric_tpu_torch.datasets.graphs import cora_graph

    summary = {"graphs": args.graphs, "first": args.first,
               "routes_differ": 0, "plain_gate_fails": 0,
               "routed_gate_fails": 0}
    try:
        for h in range(args.first, args.first + args.graphs):
            synthetic.hash = lambda _name, h=h: h
            g = cora_graph(args.device)[1]
            graphs = {args.device: g, "cpu": g.to("cpu")}
            gen = torch.Generator().manual_seed(0)
            for name, conv, call in max_convs(g.num_node_features, 16, gen):
                res = compare(conv, call(graphs), lambda dev: {},
                              graphs["cpu"].x, gen, args.device,
                              max_aggr=True)
                plain_ok = max(res["out_rel_err"], res["dx_rel_err"],
                               res["param_grad_rel_err"]) <= TOL
                ok = max(res["gate"]) <= TOL
                print(json.dumps({
                    "hash": h, "conv": name,
                    **{k: res[k] for k in (
                        "max_routes_differ", "messages_rel_err",
                        "dx_rel_err", "param_grad_rel_err",
                        "dx_rel_err_card_routes",
                        "param_grad_rel_err_card_routes")},
                    "ok": ok, "plain_ok": plain_ok}), flush=True)
                summary["routes_differ"] += res["max_routes_differ"] > 0
                summary["plain_gate_fails"] += not plain_ok
                summary["routed_gate_fails"] += not ok
    finally:
        del synthetic.hash
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
