"""One packed-GAT layer on the PubMed full-graph shape: forward and
forward + backward.

    python -m pytorch_geometric_tpu_torch.tools.gat_sweep
        [--dataset Pubmed] [--rate 0.6] [--calls 50] [--device cuda]

Counterpart of ``tools/gat_sweep.py``. The graph is its ``build_graph``:
Planetoid (``--dataset``, PubMed by default) -> ``NormalizeFeatures`` ->
``reorder_graph`` (RCM) -> ``from_data``, and the operator a
``PackedFlashGat`` over the dense mask's entries (``gat_flash_op``). One
layer of H = 8 heads of C = 8 channels, ``d``, ``s`` and ``h`` drawn
from ``numpy.random.default_rng(0)`` at 0.1 scale, attention dropout
``--rate``. Its kernels' forward (num‖den and the shift's m) and
backward are checked against their plain versions once (fp32, 1e-5),
then the layer's forward and forward + backward are timed, beside
``bounds.py``'s bound. One JSON line.

The JAX script's ``--geoms`` (window x tile pack geometries) and
``--onehot`` have no counterpart: a CSR has no window or tile, and the
kernels gather rows directly. ``--calls`` stands for its ``--K``.
"""

import argparse

import numpy as np
import torch

from pytorch_geometric_tpu_torch.tools.common import (
    add_device, check, emit, timed, where)

H, C = 8, 8


def build_graph(name: str = "Pubmed", device="cuda"):
    """The JAX ``build_graph``'s graph on ``device``: Planetoid ``name``,
    features normalised, nodes relabelled by RCM."""
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.datasets.graphs import pubmed_data

    _, data, _ = pubmed_data(name)
    return from_data(data, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="Pubmed")
    ap.add_argument("--rate", type=float, default=0.6)
    add_device(ap)
    args = ap.parse_args(argv)
    info = where(args.device)
    from pytorch_geometric_tpu_torch.bounds import gat_bound
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    graph = build_graph(args.dataset, args.device)
    op = gat_flash_op(graph)
    n, dev, rate = graph.num_nodes, graph.device, args.rate
    rng = np.random.default_rng(0)
    d, s, h = (torch.from_numpy((0.1 * rng.normal(size=shape)).astype(
        np.float32)).to(dev) for shape in ((n, H), (n, H), (n, H * C)))
    g = torch.from_numpy(rng.normal(size=(n, H * C + H)).astype(
        np.float32)).to(dev)
    seed = torch.tensor([1], dtype=torch.int32, device=dev)
    m = pg.receiver_max(op.fwd, s)
    fwd_err = check("packed_gat_fwd",
                    pg.packed_gat_fwd(op.fwd, d, s, h, seed, rate),
                    (pg.packed_gat_fwd_plain(op.fwd, d, s, h, m, seed, rate),
                     m), 1e-5)
    bwd_err = check("packed_gat_bwd",
                    pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m,
                                      seed, g, rate),
                    pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g,
                                            rate), 1e-5)
    ins = [t.clone().requires_grad_() for t in (d, s, h)]

    def fwd():
        with torch.no_grad():
            op(d, s, h, 1, rate=rate)

    def fwd_bwd():
        out = op(*ins, 1, rate=rate)
        torch.autograd.grad((out * out).sum(), ins)

    bound_f = gat_bound(op, H, C, False)[0]
    bound_b = gat_bound(op, H, C, True)[0]
    records = []
    emit(records, {"tool": "gat_sweep", "dataset": args.dataset, "rows": n,
                   "edges": op.E, "H": H, "C": C, "rate": rate,
                   "fwd_err": fwd_err, "bwd_err": bwd_err,
                   **timed("fwd", fwd, dev, args.calls),
                   **timed("fwd_bwd", fwd_bwd, dev, args.calls),
                   "fwd_bound_us": bound_f * 1e3,
                   "fwd_bwd_bound_us": (bound_f + bound_b) * 1e3,
                   "calls": args.calls, **info})
    return records


if __name__ == "__main__":
    main()
