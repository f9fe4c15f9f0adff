"""Hybrid SpMM: the edges of dense window pairs in bf16, the rest in fp32.

Counterpart of ``pytorch_geometric_tpu/ops/hybrid_spmm.py``, the
aggregation of the JAX GCN trainer's ``pallas=True`` path
(``models/citation.py:111-125``). The split is the JAX package's, on the
host: each edge's bucket is its (destination window, source window) pair
of ``window`` rows; the edges of buckets holding at least
``dense_threshold`` edges (default ``tile // 2``) are the dense part, the
rest the sparse part. ``window`` and ``tile`` pick nothing on the card
but this split, which decides which edges are summed from bf16 x.

On the card both parts are ``SpmmOperator`` s, so each runs the
``spmm_csr`` kernel: the dense part with ``compute_dtype`` (bf16 by
default: x handed to the kernel in bf16, the products and sums in fp32),
the remainder in fp32. The JAX kernel rounds each dense message to bf16
before it sums them (``ops/spmm.py:87``); this one keeps the product in
fp32, so the two agree to bf16's precision, not bitwise.

``edge_mask`` names the edges that weigh 0 by contract (a graph's
padding edges, all on the padding node): they count in the split, as in
the JAX package, but neither operator holds them, so no CSR row grows
long with them. Their weight gradient is still ``<g[r], x[s]>``.
"""

import numpy as np
import torch

from pytorch_geometric_tpu_torch.ops.csr import host_array
from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator


class HybridSpmm:
    """``out[r] = sum_e w_e x[s_e]``; differentiable in (weights, x).

    Two ``spmm_csr`` launches a direction (one when a part is empty);
    ``dense_frac`` is the share of edges in the dense part."""

    def __init__(self, senders, receivers, num_nodes, *, window=1024,
                 tile=512, dense_threshold=None,
                 compute_dtype=torch.bfloat16, device="cuda",
                 edge_mask=None):
        from pytorch_geometric_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        senders = host_array(senders).astype(np.int64)
        receivers = host_array(receivers).astype(np.int64)
        self.num_nodes = int(num_nodes)
        thresh = dense_threshold if dense_threshold is not None \
            else tile // 2

        sw = senders // window
        dw = receivers // window
        nw = -(-self.num_nodes // window)
        key = dw * nw + sw
        _, inv, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
        dense_mask = counts[inv.reshape(-1)] >= thresh
        self.dense_frac = float(dense_mask.mean()) if len(senders) else 0.0

        keep = np.ones(len(senders), bool) if edge_mask is None \
            else host_array(edge_mask).astype(bool)
        # (operator, its edge ids, those ids at its forward and its
        # backward CSR positions), the dense part first
        self.parts = []
        for part, dtype in ((dense_mask, compute_dtype),
                            (~dense_mask, torch.float32)):
            ids = np.flatnonzero(part & keep)
            if not len(ids):
                continue
            op = SpmmOperator(senders[ids], receivers[ids], self.num_nodes,
                              compute_dtype=dtype, device=dev)
            sel = torch.from_numpy(ids).to(dev)
            self.parts.append((op, sel, sel[op.fwd.perm], sel[op.bwd.perm]))
        self.senders = torch.from_numpy(senders).to(dev)
        self.receivers = torch.from_numpy(receivers).to(dev)

    def bind(self, weights):
        """``f(x)`` with *static* ``weights`` (edge order) routed into
        each part's CSRs once; differentiable in x only."""
        w = weights.detach().float() if isinstance(weights, torch.Tensor) \
            else torch.from_numpy(np.asarray(weights, np.float32))
        w = w.to(self.senders.device)
        fns = [op.bind(w[ids]) for op, ids, _, _ in self.parts]

        def f(x):
            return _sum_parts([fn(x) for fn in fns], self.num_nodes, x)

        return f

    def __call__(self, weights, x):
        return _HybridApply.apply(weights, x, self)


def _sum_parts(outs, num_nodes, x):
    if not outs:
        return torch.zeros((num_nodes, x.shape[1]), dtype=torch.float32,
                           device=x.device)
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return out


class _HybridApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, x, op):
        ctx.op = op
        ctx.save_for_backward(weights, x)
        w = weights.float()
        return _sum_parts([part._run(part.fwd, w[ids_f], x)
                           for part, _, ids_f, _ in op.parts], op.num_nodes,
                          x)

    @staticmethod
    def backward(ctx, g):
        weights, x = ctx.saved_tensors
        op = ctx.op
        dw = dx = None
        if ctx.needs_input_grad[1]:
            w = weights.float()
            dx = _sum_parts([part._run(part.bwd, w[ids_b], g.float())
                             for part, _, _, ids_b in op.parts],
                            x.shape[0], g).to(x.dtype)
        if ctx.needs_input_grad[0]:
            # every edge's, the masked ones' too, as the JAX VJP
            dw = (g[op.receivers] * x[op.senders].float()).sum(-1)
            dw = dw.to(weights.dtype)
        return dw, dx, None
