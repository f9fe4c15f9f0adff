"""Port parity, graph-level models: ``models/graph_pred.py`` and
``nn/models/`` against the JAX package, on the same numpy inputs and
carried flax parameters:

- ``GraphClassifier`` and ``graph_xent_loss``: logits (the padding
  graph's row included) and gradients, through the plain path and
  through the batch's operators (``gcn_spmm_operator``, ``pool_operator``);
- ``GAE``: the decoder, ``recon_loss`` with given negatives and with the
  host ``negative_sampling`` drawing them, ``test``; ``VGAE``:
  ``reparametrize`` with the noise injected (the JAX draw) and
  ``kl_loss``; ``split_edges`` and ``negative_sampling`` draw for draw;
- ``DeepGraphInfomax``, ``InfomaxHead`` and ``infomax_loss_fn`` with the
  corruption's permutation injected;
- the numpy ``roc_auc_score`` / ``average_precision_score`` against
  sklearn's, ties included, and the infomax example's
  ``LogisticRegression`` against sklearn's (accuracy within 0.01).

Tolerances: fp32 1e-5 relative to the largest reference magnitude,
gradients 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from sklearn import linear_model, metrics

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data.batch import collate as j_collate
from pytorch_geometric_tpu.models.graph_pred import (
    GraphClassifier as JGraphClassifier)
from pytorch_geometric_tpu.models.graph_pred import (
    graph_xent_loss as j_graph_xent_loss)
from pytorch_geometric_tpu.nn.conv import GCNConv as JGCNConv
from pytorch_geometric_tpu.nn.models import autoencoder as jae
from pytorch_geometric_tpu.nn.models import infomax as jinfomax
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data
from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.examples.infomax import LogisticRegression
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.models.graph_pred import (
    GraphClassifier, graph_xent_loss)
from pytorch_geometric_tpu_torch.nn.conv import GCNConv
from pytorch_geometric_tpu_torch.nn.models import (
    GAE, VGAE, DeepGraphInfomax, InfomaxHead, average_precision_score,
    infomax_loss_fn, negative_sampling, roc_auc_score, split_edges)
from pytorch_geometric_tpu_torch.nn.pool import pool_operator

F = 5


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_() if grad else t


def _datas(seed, count, cls):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 12))
        ei = np.stack([rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)])
        out.append(cls(x=rng.normal(size=(n, F)).astype(np.float32),
                       edge_index=np.concatenate([ei, ei[::-1]], 1),
                       y=np.int64(rng.integers(0, 3))))
    return out


def _batches(seed=0, count=4):
    return (collate(_datas(seed, count, Data), device="cpu"),
            j_collate(_datas(seed, count, JData)))


# ---------------------------------------------------------------------------
# GraphClassifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "operators"])
def test_graph_classifier_matches_jax(route):
    g, jg = _batches(1)
    jmod = JGraphClassifier(hidden_channels=8, num_classes=3, num_layers=2)
    params = jmod.init(jax.random.PRNGKey(0), jg)

    def loss(p):
        logits = jmod.apply(p, jg)
        return j_graph_xent_loss(logits, jg.y, jg.graph_mask), logits

    (want_loss, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    mod = GraphClassifier(F, 8, 3, num_layers=2)
    mod.load_state_dict(params_from_jax(params))
    kw = {}
    if route == "operators":
        op, w = gcn_spmm_operator(g)
        kw = {"aggregate_fn": op.bind(w), "segment_op": pool_operator(g)}
    logits = mod(g, **kw)
    out = graph_xent_loss(logits, g.y, g.graph_mask)
    out.backward()
    assert logits.shape == (g.num_graphs, 3)
    _close(logits, want, 1e-5)
    _close(out, want_loss, 1e-5)
    want = params_from_jax(grads)
    for name, p in mod.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4)


# ---------------------------------------------------------------------------
# autoencoders
# ---------------------------------------------------------------------------

def _edges(seed, n=30, e=40):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def test_split_edges_and_negative_sampling_draw_as_jax():
    rng = np.random.default_rng(2)
    n = 40
    ei = np.stack([rng.integers(0, n, 200), rng.integers(0, n, 200)])
    ei = np.concatenate([ei, ei[::-1]], 1)
    got = split_edges(Data(edge_index=ei.copy(), num_nodes=n), seed=3)
    want = jae.split_edges(JData(edge_index=ei.copy(), num_nodes=n), seed=3)
    for key in ("train_pos_edge_index", "val_pos_edge_index",
                "test_pos_edge_index", "val_neg_edge_index",
                "test_neg_edge_index", "edge_index"):
        np.testing.assert_array_equal(getattr(got, key),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)
    s, r = _edges(4)
    for a, b in zip(negative_sampling(torch.from_numpy(s),
                                      torch.from_numpy(r), 30, 25, seed=5),
                    jae.negative_sampling(s, r, 30, 25, seed=5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("negatives", ["given", "sampled"])
def test_gae_recon_loss_and_test_match_jax(negatives):
    rng = np.random.default_rng(6)
    z = rng.normal(size=(30, 8)).astype(np.float32)
    ps, pr = _edges(7)
    ns, nr = _edges(8)
    neg = (ns, nr) if negatives == "given" else (None, None)
    jgae = jae.GAE(None)

    def f(z):
        return jgae.recon_loss(z, jnp.asarray(ps), jnp.asarray(pr),
                               *(jnp.asarray(a) if a is not None else None
                                 for a in neg), seed=9)

    want, gz = jax.value_and_grad(f)(z)
    gae = GAE(None)
    zt = _t(z, grad=True)
    loss = gae.recon_loss(zt, torch.from_numpy(ps), torch.from_numpy(pr),
                          *(torch.from_numpy(a) if a is not None else None
                            for a in neg), seed=9)
    loss.backward()
    _close(loss, want, 1e-5)
    _close(zt.grad, gz, 1e-4)
    # the decoder, and (AUC, AP) of its scores against sklearn's (the
    # JAX ``test``'s; the two packages' float32 sigmoids round a few
    # near-equal scores apart, so sklearn scores the port's own)
    _close(gae.decoder.forward_all(zt), jgae.decoder.forward_all(z), 1e-5)
    edges = [torch.from_numpy(a) for a in (ps, pr, ns, nr)]
    pos = _np(gae.decoder(zt, *edges[:2]))
    neg = _np(gae.decoder(zt, *edges[2:]))
    _close(pos, jgae.decoder(z, jnp.asarray(ps), jnp.asarray(pr)), 1e-5)
    y = np.r_[np.ones_like(pos), np.zeros_like(neg)]
    want = (metrics.roc_auc_score(y, np.r_[pos, neg]),
            metrics.average_precision_score(y, np.r_[pos, neg]))
    np.testing.assert_allclose(gae.test(zt, *edges), want, rtol=1e-12)


def test_vgae_reparametrize_and_kl_match_jax():
    rng = np.random.default_rng(10)
    mu = rng.normal(size=(20, 6)).astype(np.float32)
    logstd = rng.normal(size=(20, 6)).astype(np.float32)
    logstd[0, 0] = 12.0                    # clipped at MAX_LOGSTD
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, mu.shape))
    jvgae = jae.VGAE(None)

    def f(mu, logstd):
        z = jvgae.reparametrize(mu, logstd, key)
        return jnp.sum(z * z) + jvgae.kl_loss(mu, logstd), z

    (want, wz), (gmu, gls) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(mu, logstd)
    vgae = VGAE(None)
    mt, lt = _t(mu, grad=True), _t(logstd, grad=True)
    z = vgae.reparametrize(mt, lt, noise=torch.from_numpy(noise))
    loss = (z * z).sum() + vgae.kl_loss(mt, lt)
    loss.backward()
    _close(z, wz, 1e-5)
    _close(loss, want, 1e-5)
    _close(mt.grad, gmu, 1e-4)
    _close(lt.grad, gls, 1e-4)
    assert vgae.reparametrize(mt, lt, training=False) is mt
    # the noise from a generator: a standard normal of mu's shape
    gen = torch.Generator().manual_seed(0)
    a = vgae.reparametrize(mt, lt, gen)
    b = vgae.reparametrize(mt, lt, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, mt)


# ---------------------------------------------------------------------------
# Deep Graph Infomax
# ---------------------------------------------------------------------------

class _JEncoder(fnn.Module):
    @fnn.compact
    def __call__(self, graph, x):
        return fnn.tanh(JGCNConv(8)(graph, x))


class _Encoder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.GCNConv_0 = GCNConv(F, 8)

    def forward(self, graph, x, aggregate_fn=None):
        return torch.tanh(self.GCNConv_0(graph, x, aggregate_fn=aggregate_fn))


class _JModel(fnn.Module):
    perm: tuple

    @fnn.compact
    def __call__(self, graph, x):
        dgi = jinfomax.DeepGraphInfomax(
            hidden_channels=8, encoder=_JEncoder(),
            corruption=lambda g, xx, r: (g, xx[jnp.asarray(self.perm)]))
        pos_z, neg_z, s = dgi(graph, x, rng=jax.random.PRNGKey(0))
        return jinfomax.InfomaxHead(hidden_channels=8)(pos_z, neg_z, s), \
            (pos_z, neg_z, s)


@pytest.mark.parametrize("route", ["plain", "operator"])
def test_deep_graph_infomax_matches_jax(route):
    g, jg = _batches(12)
    perm = np.random.default_rng(13).permutation(g.num_nodes)
    jmod = _JModel(tuple(int(i) for i in perm))
    params = jmod.init(jax.random.PRNGKey(1), jg, jg.x)
    (want, (pz, nz, s)), grads = jax.value_and_grad(
        lambda p: jmod.apply(p, jg, jg.x), has_aux=True)(params)
    names = {"_JEncoder_0": "dgi.encoder", "InfomaxHead_0": "head"}
    dgi = DeepGraphInfomax(8, _Encoder(),
                           lambda g_, xx, r: (g_, xx[torch.from_numpy(perm)]))
    head = InfomaxHead(8)
    model = torch.nn.ModuleDict({"dgi": dgi, "head": head})
    state = params_from_jax(params, names)
    model.load_state_dict(state)
    kw = {}
    if route == "operator":
        op, w = gcn_spmm_operator(g)
        kw = {"aggregate_fn": op.bind(w)}
    pos_z, neg_z, summary = dgi(g, g.x, rng=None, **kw)
    loss = head(pos_z, neg_z, summary)
    loss.backward()
    for a, b in ((pos_z, pz), (neg_z, nz), (summary, s), (loss, want)):
        _close(a, b, 1e-5)
    _close(infomax_loss_fn(pos_z, neg_z, summary, head.weight), want, 1e-5)
    _close(dgi.discriminate(pos_z, summary, head.weight),
           np.asarray(pz) @ np.asarray(params_from_jax(params)[
               "InfomaxHead_0.weight"]) @ np.asarray(s), 1e-5)
    want = params_from_jax(grads, names)
    for name, p in model.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4)


# ---------------------------------------------------------------------------
# the numpy metrics and the logistic regression, against sklearn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_and_ap_match_sklearn_with_ties(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 300)
    score = np.round(rng.normal(size=300) + 0.7 * y, 1)   # many ties
    if seed == 2:
        score = score.astype(np.float32)
    assert roc_auc_score(y, score) == pytest.approx(
        metrics.roc_auc_score(y, score), abs=1e-12)
    assert average_precision_score(y, score) == pytest.approx(
        metrics.average_precision_score(y, score), abs=1e-12)


@pytest.mark.parametrize("classes", [2, 4])
def test_logistic_regression_matches_sklearn(classes):
    rng = np.random.default_rng(classes)
    n, d = 400, 16
    centers = rng.normal(size=(classes, d))
    y = rng.integers(0, classes, n)
    X = (centers[y] + 1.5 * rng.normal(size=(n, d))).astype(np.float32)
    tr, te = np.arange(n) < 250, np.arange(n) >= 250
    ours = LogisticRegression(max_iter=300).fit(X[tr], y[tr])
    ref = linear_model.LogisticRegression(max_iter=300).fit(X[tr], y[tr])
    assert abs(ours.score(X[te], y[te]) - ref.score(X[te], y[te])) <= 0.01
    assert 0.5 < ref.score(X[te], y[te]) < 1.0     # not a trivial split
    coef = ref.coef_.T if classes > 2 else ref.coef_.T
    np.testing.assert_allclose(ours.coef_, coef, rtol=1e-2,
                               atol=1e-2 * np.abs(coef).max())
    np.testing.assert_array_equal(ours.predict(X[te]) == ref.predict(X[te]),
                                  True)
