"""Deep Graph Infomax on Cora: the port's counterpart of
examples/infomax.py. A one-layer GCN encoder 1433 -> 512 with a PReLU
(one slope, 0.25); the corruption shuffles the node rows; the summary is
the sigmoid of the mean embedding; a bilinear discriminator (uniform
init) and its cross-entropy; Adam 1e-3, 50 epochs; then a logistic
regression on the train nodes' embeddings, its test accuracy printed.

    python -m pytorch_geometric_tpu_torch.examples.infomax [--epochs 50]

Both encoder calls aggregate through the ``SpmmOperator`` of the graph's
``gcn_edge_set`` (``models/citation.py:gcn_spmm_operator``, built once on
the host): the ``spmm_csr`` kernel on a card, at F = 512 (the GCN
multiplies by its weight first). The permutation is
``torch.randperm`` from a ``torch.Generator`` seeded from ``seed``. The
JAX script's probe is sklearn's ``LogisticRegression(max_iter=300)``; the
card's machine has no sklearn, so :class:`LogisticRegression` is the
port's own, with sklearn's defaults (L2, C = 1, lbfgs through scipy,
300 iterations, the objective as sklearn scales it).

The JAX script jits its epoch. Here, on a card, the epoch (the encoder on
the graph and on its corruption, forward and back, and Adam) is a CUDA
graph captured once and replayed (``models/capture.py:EpochSpans``,
``capture=None`` or ``True``) in spans of 10 epochs, each span's last
loss printed between them; the permutation is drawn inside the graph from
the generator registered with it. The embeddings and the probe run
eagerly after training. ``capture=False`` runs the same epochs from
Python (the CPU's only mode).
"""

import argparse
import time

import numpy as np
import torch
from torch import nn

from pytorch_geometric_tpu_torch.data import from_data
from pytorch_geometric_tpu_torch.datasets import Planetoid
from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.models.capture import (
    EpochSpans, resolve_capture)
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn.conv import GCNConv
from pytorch_geometric_tpu_torch.nn.models import (
    DeepGraphInfomax, InfomaxHead)
from pytorch_geometric_tpu_torch.ops.csr import host_array

#: The flax names of the JAX script's modules (adopted by its ``Model``)
#: and the port's, for ``convert.params_from_jax(..., names=FLAX_NAMES)``.
FLAX_NAMES = {"Encoder_0": "dgi.encoder", "InfomaxHead_0": "head"}


class Encoder(nn.Module):
    """examples/infomax.py's ``Encoder``: ``GCNConv_0`` and ``prelu``."""

    def __init__(self, in_channels: int, hidden: int = 512,
                 generator=None):
        super().__init__()
        self.GCNConv_0 = GCNConv(in_channels, hidden, generator=generator)
        self.prelu = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, graph, x, aggregate_fn=None):
        x = self.GCNConv_0(graph, x, aggregate_fn=aggregate_fn)
        return torch.where(x > 0, x, self.prelu * x)


def shuffle_rows(graph, x, rng):
    """The corruption: x's rows in a random order from ``rng``."""
    perm = torch.randperm(x.shape[0], generator=rng, device=x.device)
    return graph, x[perm]


class Model(nn.Module):
    """examples/infomax.py's ``Model``: ``dgi`` (its encoder is the JAX
    ``Encoder_0``) and ``head`` (``InfomaxHead_0``). ``corruption``
    defaults to :func:`shuffle_rows`."""

    def __init__(self, in_channels: int, hidden: int = 512, corruption=None,
                 generator=None):
        super().__init__()
        self.dgi = DeepGraphInfomax(hidden, Encoder(in_channels, hidden,
                                                    generator),
                                    corruption or shuffle_rows)
        self.head = InfomaxHead(hidden, generator=generator)

    def forward(self, graph, x, rng=None, aggregate_fn=None):
        pos_z, neg_z, s = self.dgi(graph, x, rng=rng,
                                   aggregate_fn=aggregate_fn)
        return self.head(pos_z, neg_z, s), pos_z


class LogisticRegression:
    """Multinomial (binary for two classes) logistic regression with an
    L2 penalty on the weights, not the intercept: sklearn's
    ``LogisticRegression(C, max_iter)`` with its lbfgs solver, the
    objective mean loss + ||W||^2 / (2 C n) minimised by scipy's
    L-BFGS-B from zeros (gtol ``tol``, ftol 64 eps, 50 line-search
    steps), in float64."""

    def __init__(self, C: float = 1.0, max_iter: int = 300,
                 tol: float = 1e-4):
        self.C, self.max_iter, self.tol = C, max_iter, tol

    def _objective(self, w, X, Y):
        n, d = X.shape
        k = Y.shape[1]
        W = w[:d * k].reshape(d, k)
        z = X @ W + w[d * k:]
        if k == 1:       # binary: y in {0, 1}, one logit
            loss = np.logaddexp(0.0, z) - Y * z
            dz = 1.0 / (1.0 + np.exp(-z)) - Y
        else:
            z = z - z.max(1, keepdims=True)
            lse = np.log(np.exp(z).sum(1, keepdims=True))
            loss = lse - (Y * z).sum(1, keepdims=True)
            dz = np.exp(z - lse) - Y
        reg = 1.0 / (self.C * n)
        f = loss.sum() / n + 0.5 * reg * (W * W).sum()
        g = np.concatenate([(X.T @ dz / n + reg * W).ravel(),
                            dz.sum(0) / n])
        return f, g

    def fit(self, X, y):
        from scipy import optimize

        X = np.asarray(X, dtype=np.float64)
        self.classes_, y = np.unique(np.asarray(y), return_inverse=True)
        k = 1 if len(self.classes_) == 2 else len(self.classes_)
        Y = y[:, None].astype(np.float64) if k == 1 else np.eye(k)[y]
        w0 = np.zeros(X.shape[1] * k + k)
        res = optimize.minimize(
            self._objective, w0, args=(X, Y), method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50,
                     "gtol": self.tol, "ftol": 64 * np.finfo(float).eps})
        d = X.shape[1]
        self.coef_ = res.x[:d * k].reshape(d, k)
        self.intercept_ = res.x[d * k:]
        return self

    def predict(self, X):
        z = np.asarray(X, dtype=np.float64) @ self.coef_ + self.intercept_
        idx = (z[:, 0] > 0).astype(np.int64) if z.shape[1] == 1 \
            else z.argmax(1)
        return self.classes_[idx]

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))


def load(root=PLANETOID_ROOT, device="cuda"):
    """Cora under ``root`` as one graph on ``device``."""
    return from_data(Planetoid(str(root), "Cora")[0], device=device)


def run(epochs: int = 50, seed: int = 0, hidden: int = 512,
        device="cuda", graph=None, capture=None):
    """Train, print the JAX script's lines, and probe the embeddings.
    ``graph`` replaces :func:`load`'s; ``capture`` (see the module
    docstring) None means captured on a card and eager on the CPU, True
    elsewhere than a card raises. Returns the probe's accuracy, every
    epoch's loss, the operator's host seconds, the run's seconds
    (training and probe), the model, its ``EpochSpans`` (``spans``) and
    what ``EpochSpans.metrics`` gives."""
    dev = resolve_device(device)
    capture = resolve_capture(capture, dev)
    graph = graph if graph is not None else load(device=dev)
    t0 = time.perf_counter()
    op, weights = gcn_spmm_operator(graph)
    aggregate_fn = op.bind(weights)
    operator_seconds = time.perf_counter() - t0
    model = Model(graph.num_node_features, hidden,
                  generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                           capturable=dev.type == "cuda")
    rng = torch.Generator(device=dev).manual_seed(seed)

    def epoch_step():
        opt.zero_grad(set_to_none=False)
        loss, _ = model(graph, graph.x, rng, aggregate_fn)
        loss.backward()
        opt.step()
        return loss.detach()

    spans = EpochSpans(epoch_step, epochs, dev, capture, rng)
    losses = []
    t0 = time.perf_counter()
    while spans.epochs < epochs:
        losses.extend(spans.span(min(10, epochs - spans.epochs))[:, 0])
        if spans.epochs % 10 == 0:
            print(f"Epoch {spans.epochs:03d}, Loss: {losses[-1]:.4f}")
    with torch.no_grad():
        z = spans.between(lambda: host_array(
            model(graph, graph.x, rng, aggregate_fn)[1]))
    nm = host_array(graph.node_mask)
    y = host_array(graph.y)
    tr = host_array(graph.train_mask) & nm
    te = host_array(graph.test_mask) & nm
    clf = LogisticRegression(max_iter=300).fit(z[tr], y[tr])
    acc = clf.score(z[te], y[te])
    print(f"LogReg test accuracy: {acc:.4f}")
    return {"acc": acc, "losses": np.asarray(losses),
            "operator_seconds": operator_seconds,
            "run_seconds": time.perf_counter() - t0, "model": model,
            "spans": spans, **spans.metrics()}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=50)
    args = p.parse_args()
    run(args.epochs)
