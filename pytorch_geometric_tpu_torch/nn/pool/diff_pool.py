"""Dense differentiable pooling (Ying et al.).

Counterpart of ``pytorch_geometric_tpu/nn/pool/diff_pool.py`` (reference:
``torch_geometric.nn.dense_diff_pool``; examples/enzymes_diff_pool.py:
9,101): soft assignment S = softmax(s); X' = S^T X; A' = S^T A S; the
link-prediction loss ||A - S S^T||_F / |A| and the entropy regulariser
mean(H(S_i)).

Dense batched tensors (B, N, ...): batched products (``torch.einsum``),
which the JAX package also computes outside any Pallas kernel.
"""

import torch


def dense_diff_pool(x, adj, s, mask=None):
    """x: (B, N, F), adj: (B, N, N), s: (B, N, C) raw scores, mask:
    (B, N) or None. Returns ``(x', adj', link_loss, ent_loss)``."""
    if x.ndim == 2:
        x, adj, s = x[None], adj[None], s[None]
    s = torch.softmax(s, dim=-1)
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        x = x * m
        s = s * m

    out_x = torch.einsum("bnc,bnf->bcf", s, x)
    out_adj = torch.einsum("bnc,bnm,bmd->bcd", s, adj, s)

    ss_t = torch.einsum("bnc,bmc->bnm", s, s)
    link_loss = torch.linalg.norm(adj - ss_t, dim=(-2, -1))
    denom = adj.shape[-1] * adj.shape[-2]
    link_loss = link_loss.mean() / denom

    ent = -(s * torch.log(s + 1e-15)).sum(-1)
    if mask is not None:
        ent_loss = (ent * mask.to(x.dtype)).sum() / \
            mask.sum().to(x.dtype).clamp_min(1.0)
    else:
        ent_loss = ent.mean()
    return out_x, out_adj, link_loss, ent_loss
