"""Port parity, the conv zoo: every conv of ``nn/conv/`` that this slice
ports (SGConv, AGNNConv, ARMAConv, SplineConv, DNAConv, GraphConv,
GINConv, SAGEConv, DenseSAGEConv, ChebConv, NNConv, EdgeConv, PointConv)
against the JAX package's, with the JAX parameters carried over by
``convert.params_from_jax`` (so the parameter names and layouts are
checked too): the output, the input gradient and every parameter
gradient, on its plain CPU path and on its operator path (the operators
built on the CPU, where each kernel wrapper computes its plain version).
Then ``spline_basis`` for degrees 1-3, open and closed, and each conv
against the PyG 1.4.x torch oracles of ``tests/test_torch_oracle*.py``
(the same formulas, on the port's own parameters and the unpadded
edges). Tolerances: fp32 1e-5 relative to the largest reference
magnitude, gradients 1e-4 (parameter gradients relative to the
largest of them); oracles 1e-5 on the real nodes."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.nn import conv as jconv
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn import conv as tconv
from pytorch_geometric_tpu_torch.nn.layers import Dense
from pytorch_geometric_tpu_torch.nn.message_passing import (
    propagate_operators)

F, C, FE = 8, 5, 3


def _arrays(seed, n=40, e=160, unique=False):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if unique:
        ei = np.unique(ei, axis=1)
    return dict(x=rng.normal(size=(n, F)).astype(np.float32), edge_index=ei,
                edge_attr=rng.random((ei.shape[1], FE)).astype(np.float32))


def _graphs(seed=0, **kw):
    arrays = _arrays(seed, **kw)
    return (from_data(Data(**arrays), device="cpu"),
            j_from_data(JData(**arrays)), arrays)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


class JMlp(fnn.Module):
    hidden: int
    out: int

    @fnn.compact
    def __call__(self, h):
        h = fnn.relu(fnn.Dense(self.hidden)(h))   # Dense_0, then Dense_1
        return fnn.Dense(self.out)(h)


class TMlp(torch.nn.Module):
    """The port's side of ``JMlp``: the same flax names and layouts."""

    def __init__(self, f, hidden, out):
        super().__init__()
        self.Dense_0 = Dense(f, hidden)
        self.Dense_1 = Dense(hidden, out)

    def forward(self, h):
        return self.Dense_1(torch.relu(self.Dense_0(h)))


def _run(make_j, jfwd, tmod, tfwd, x_np, seed=0):
    """Parity of one conv: ``make_j()`` the flax conv, ``jfwd(f, x)`` its
    call through ``f`` (its ``init`` or ``apply``), ``tfwd(x)`` the port's
    with ``tmod`` holding the JAX parameters: the output, dx, and each
    parameter's gradient."""
    jmod = make_j()
    params = jfwd(functools.partial(jmod.init, jax.random.PRNGKey(seed)),
                  jnp.asarray(x_np))

    def jloss(p, x):
        out = jfwd(functools.partial(jmod.apply, p), x)
        return jnp.sum(out * ct), out

    ct = np.random.default_rng(seed + 100).normal(size=np.shape(
        jfwd(functools.partial(jmod.apply, params), jnp.asarray(x_np)))
    ).astype(np.float32)
    (_, want), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x_np))
    tmod.load_state_dict(params_from_jax(params), strict=True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    out = tfwd(x)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, want, 1e-5)
    _close(x.grad, gx, 1e-4)
    want_grads = params_from_jax(gp)
    got = dict(tmod.named_parameters())
    assert sorted(got) == sorted(want_grads)
    # relative to the largest parameter gradient: a gradient that is 0 in
    # exact arithmetic (DNA's key bias: the softmax over the history does
    # not see a shift common to every key) is rounding noise in both
    scale = max([float(g.abs().max()) for g in want_grads.values()] + [0])
    for name, p in got.items():
        np.testing.assert_allclose(_np(p.grad), _np(want_grads[name]),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


PATHS = ["plain", "operators"]


def _x(g):
    """The graph's (padded) features as a numpy array."""
    return g.x.numpy().copy()


@pytest.mark.parametrize("path", PATHS)
def test_sgconv_matches_jax(path):
    g, jg, _ = _graphs(1)
    conv = tconv.SGConv(F, C, K=2)
    kw = {}
    if path == "operators":
        op, w = gcn_spmm_operator(g)
        kw = {"aggregate_fn": op.bind(w)}
    _run(lambda: jconv.SGConv(C, K=2), lambda m, x: m(jg, x), conv,
         lambda x: conv(g, x, **kw), _x(g))
    # the cached features give the same output as the propagation
    with torch.no_grad():
        cached = tconv.sgc_precompute(g, g.x, 2, kw.get("aggregate_fn"))
        _close(conv(g, None, cached_x=cached), conv(g, g.x, **kw), 1e-6)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("requires_grad", [False, True])
def test_agnnconv_matches_jax(path, requires_grad):
    g, jg, _ = _graphs(2)
    conv = tconv.AGNNConv(requires_grad=requires_grad)
    kw = tconv.agnn_operators(g) if path == "operators" else {}
    if requires_grad:   # beta off its init, so that it matters
        params = {"params": {"beta": jnp.asarray([1.3])}}
        want = jconv.AGNNConv(True).apply(params, jg, jg.x)
        conv.load_state_dict(params_from_jax(params))
        _close(conv(g, g.x, **kw), want, 1e-5)
    _run(lambda: jconv.AGNNConv(requires_grad), lambda m, x: m(jg, x), conv,
         lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("layers", [1, 3])
def test_armaconv_matches_jax(path, shared, layers):
    g, jg, _ = _graphs(3)
    conv = tconv.ARMAConv(F, C, num_stacks=3, num_layers=layers,
                          shared_weights=shared, dropout=0.25)
    kw = {"lap_fn": tconv.arma_operator(g)} if path == "operators" else {}
    _run(lambda: jconv.ARMAConv(C, num_stacks=3, num_layers=layers,
                                shared_weights=shared, dropout=0.25),
         lambda m, x: m(jg, x), conv, lambda x: conv(g, x, **kw), _x(g))


SPLINES = [  # (dim, kernel_size, open, degree, aggr)
    (1, 2, True, 1, "add"), (1, 5, False, 1, "mean"), (2, 3, True, 2, "add"),
    (2, [3, 4], False, 3, "add"), (3, 3, True, 1, "mean")]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("dim,ks,open_,degree,aggr", SPLINES)
def test_splineconv_matches_jax(path, dim, ks, open_, degree, aggr):
    g, jg, _ = _graphs(4)
    conv = tconv.SplineConv(F, C, dim=dim, kernel_size=ks,
                            is_open_spline=open_, degree=degree, aggr=aggr)
    pseudo = g.edge_attr[:, :dim]
    kw = {"spline_fns": tconv.spline_operators(
        g, dim, ks, open_, degree, pseudo=pseudo)} \
        if path == "operators" else {"pseudo": pseudo}
    _run(lambda: jconv.SplineConv(C, dim=dim, kernel_size=ks,
                                  is_open_spline=open_, degree=degree,
                                  aggr=aggr),
         lambda m, x: m(jg, x, pseudo=jg.edge_attr[:, :dim]), conv,
         lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("open_", [True, False])
@pytest.mark.parametrize("dim,ks", [(1, [4]), (2, [3, 5]), (3, [2, 3, 4])])
def test_spline_basis_matches_jax(degree, open_, dim, ks):
    rng = np.random.default_rng(5)
    pseudo = rng.random((50, dim)).astype(np.float32)
    pseudo[:3] = [[0.0] * dim, [1.0] * dim, [0.5] * dim]   # the ends
    flags = [int(open_)] * dim
    jw, ji = jconv.spline_basis(jnp.asarray(pseudo), ks, flags, degree)
    tw, ti = tconv.spline_basis(torch.from_numpy(pseudo), ks, flags, degree)
    _close(tw, jw, 1e-6)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    # each edge's weights sum to 1 (a partition of unity)
    np.testing.assert_allclose(_np(tw).sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("path", PATHS)
def test_dnaconv_matches_jax(path):
    g, jg, _ = _graphs(6)
    L, H, G = 3, 2, 2
    x_all = np.random.default_rng(7).normal(
        size=(g.num_nodes, L, F)).astype(np.float32)
    conv = tconv.DNAConv(F, heads=H, groups=G)
    kw = tconv.dna_operators(g) if path == "operators" else {}
    _run(lambda: jconv.DNAConv(F, heads=H, groups=G), lambda m, x: m(jg, x),
         conv, lambda x: conv(g, x, **kw), x_all)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_graphconv_matches_jax(path, aggr):
    g, jg, _ = _graphs(8)
    conv = tconv.GraphConv(F, C, aggr=aggr)
    kw = propagate_operators(g) if path == "operators" else {}
    _run(lambda: jconv.GraphConv(C, aggr=aggr), lambda m, x: m(jg, x), conv,
         lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("train_eps", [False, True])
def test_ginconv_matches_jax(path, train_eps):
    g, jg, _ = _graphs(9)
    conv = tconv.GINConv(TMlp(F, 9, C), eps=0.3, train_eps=train_eps)
    kw = propagate_operators(g) if path == "operators" else {}
    _run(lambda: jconv.GINConv(JMlp(9, C), eps=0.3, train_eps=train_eps),
         lambda m, x: m(jg, x), conv, lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("normalize", [False, True])
def test_sageconv_matches_jax(path, normalize):
    g, jg, _ = _graphs(10)
    conv = tconv.SAGEConv(F, C, normalize=normalize)
    kw = propagate_operators(g) if path == "operators" else {}
    _run(lambda: jconv.SAGEConv(C, normalize=normalize),
         lambda m, x: m(jg, x), conv, lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_dense_sageconv_matches_jax(normalize, batched):
    rng = np.random.default_rng(11)
    B, N = 3, 12
    adj = jnp.asarray((rng.random((B, N, N)) < 0.3).astype(np.float32))
    mask = jnp.asarray(rng.random((B, N)) < 0.8)
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    if not batched:
        adj, mask, x = adj[0], None, x[0]
    conv = tconv.DenseSAGEConv(F, C, normalize=normalize)
    tadj = torch.from_numpy(np.array(adj))
    tmask = None if mask is None else torch.from_numpy(np.array(mask))
    _run(lambda: jconv.DenseSAGEConv(C, normalize=normalize),
         lambda m, x: m(x, adj, mask), conv, lambda x: conv(x, tadj, tmask),
         x)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("K", [1, 2, 3])
def test_chebconv_matches_jax(path, K):
    g, jg, _ = _graphs(12)
    conv = tconv.ChebConv(F, C, K=K)
    kw = {"lap_fn": tconv.cheb_operator(g)} if path == "operators" else {}
    _run(lambda: jconv.ChebConv(C, K=K), lambda m, x: m(jg, x), conv,
         lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_nnconv_matches_jax(path, aggr):
    g, jg, _ = _graphs(13)
    conv = tconv.NNConv(F, C, Dense(FE, F * C), aggr=aggr)
    kw = {"segment_op": propagate_operators(g)["segment_op"]} \
        if path == "operators" else {}
    _run(lambda: jconv.NNConv(C, fnn.Dense(F * C), aggr=aggr),
         lambda m, x: m(jg, x), conv, lambda x: conv(g, x, **kw), _x(g))


@pytest.mark.parametrize("aggr", ["max", "min", "add", "mean"])
def test_edgeconv_matches_jax(aggr):
    g, jg, _ = _graphs(14)
    conv = tconv.EdgeConv(Dense(2 * F, C), aggr=aggr)
    kw = {"segment_op": propagate_operators(g)["segment_op"]} \
        if aggr in ("add", "mean") else {}
    _run(lambda: jconv.EdgeConv(fnn.Dense(C), aggr=aggr),
         lambda m, x: m(jg, x), conv, lambda x: conv(g, x, **kw), _x(g))


def _point_inputs(seed=15, n_src=30, n_dst=12, e=90):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_src, F)).astype(np.float32),
            rng.normal(size=(n_src, 3)).astype(np.float32),
            rng.normal(size=(n_dst, 3)).astype(np.float32),
            rng.integers(0, n_src, e), rng.integers(0, n_dst - 2, e),
            rng.random(e) < 0.9, n_dst)


@pytest.mark.parametrize("bipartite", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pointconv_matches_jax(bipartite, masked):
    x, pos, pos_dst, s, r, em, n_dst = _point_inputs()
    if not bipartite:
        r, n_dst = np.minimum(r, x.shape[0] - 1), x.shape[0]
    jpos = (jnp.asarray(pos), jnp.asarray(pos_dst)) if bipartite \
        else jnp.asarray(pos)
    tpos = (torch.from_numpy(pos), torch.from_numpy(pos_dst)) if bipartite \
        else torch.from_numpy(pos)
    jm = jnp.asarray(em) if masked else None
    tm = torch.from_numpy(em) if masked else None
    conv = tconv.PointConv(Dense(F + 3, 10), Dense(10, 7))
    ts, tr = torch.from_numpy(s), torch.from_numpy(r)
    _run(lambda: jconv.PointConv(fnn.Dense(10), fnn.Dense(7)),
         lambda m, x: m(x, jpos, jnp.asarray(s), jnp.asarray(r), n_dst, jm),
         conv, lambda x: conv(x, tpos, ts, tr, n_dst, tm), x)


@pytest.mark.parametrize("name", ["SGConv", "AGNNConv", "ARMAConv",
                                  "SplineConv", "DNAConv", "ChebConv",
                                  "NNConv"])
def test_conv_off_the_cpu_raises_without_its_operator(name):
    """A conv that sums feature rows raises off the CPU without its
    operator, before anything is summed (a meta tensor stands for the
    card)."""
    g, _, _ = _graphs(16)
    x = torch.empty(g.num_nodes, F, device="meta")
    conv, args = {
        "SGConv": (tconv.SGConv(F, C, K=2), (x,)),
        "AGNNConv": (tconv.AGNNConv(), (x,)),
        "ARMAConv": (tconv.ARMAConv(F, C), (x,)),
        "SplineConv": (tconv.SplineConv(F, C, dim=1, kernel_size=2), (x,)),
        "DNAConv": (tconv.DNAConv(F), (x[:, None],)),
        "ChebConv": (tconv.ChebConv(F, C, K=2), (x,)),
        "NNConv": (tconv.NNConv(F, C, lambda ea: ea.new_empty(
            (ea.shape[0], F * C), device="meta")), (x,)),
    }[name]
    with pytest.raises(ValueError, match="needs"):
        conv(g, *args)


# ---------------------------------------------------------------------------
# The PyG 1.4.x torch oracles of tests/test_torch_oracle*.py, on the port's
# parameters: each formula as written there, over the unpadded edges
# ---------------------------------------------------------------------------

def _scatter_add(src, index, n):
    out = torch.zeros((n,) + src.shape[1:], dtype=src.dtype)
    return out.index_add_(0, torch.as_tensor(index, dtype=torch.long), src)


def _long(a):
    return torch.as_tensor(a, dtype=torch.long)


def _oracle_case(name, g, a):
    """``(port output, oracle output)`` on the real nodes."""
    x, ei, n = torch.from_numpy(a["x"]), a["edge_index"], a["x"].shape[0]
    s, r = ei
    ones = torch.ones(ei.shape[1])
    deg = _scatter_add(ones, r, n)
    with torch.no_grad():
        if name == "GraphConv":
            conv = tconv.GraphConv(F, C, aggr="mean")
            agg = _scatter_add(x[_long(s)], r, n) \
                / deg.clamp(min=1.0)[:, None]
            return conv(g, g.x), x @ conv.weight_root + agg @ conv.weight_nbr \
                + conv.bias
        if name == "GINConv":
            conv = tconv.GINConv(TMlp(F, 9, 6), eps=0.3)
            z = 1.3 * x + _scatter_add(x[_long(s)], r, n)
            return conv(g, g.x), conv.mlp(z)
        if name == "SAGEConv":
            conv = tconv.SAGEConv(F, C)
            mean = (_scatter_add(x[_long(s)], r, n) + x) / (deg + 1)[:, None]
            return conv(g, g.x), mean @ conv.weight + conv.bias
        if name in ("ChebConv", "ARMAConv"):
            dinv = torch.where(deg > 0, deg.clamp(min=1e-12).pow(-0.5),
                               torch.zeros(()))
            wgt = dinv[_long(s)] * dinv[_long(r)]
            sign = -1.0 if name == "ChebConv" else 1.0

            def lap(v):
                return _scatter_add(v[_long(s)] * sign * wgt[:, None], r, n)
            if name == "ChebConv":
                conv = tconv.ChebConv(F, C, K=3)
                Ts = [x, lap(x)]
                Ts.append(2 * lap(Ts[-1]) - Ts[-2])
                return conv(g, g.x), sum(T @ W for T, W in
                                         zip(Ts, conv.weight)) + conv.bias
            conv = tconv.ARMAConv(F, C, num_stacks=2, num_layers=2)
            outs = []
            for k in range(2):
                h = torch.relu(lap(x @ conv.init_weight[k])
                               + x @ conv.root_weight[0, k]
                               + conv.bias[0, k])
                h = torch.relu(lap(h @ conv.weight[0, k])
                               + x @ conv.root_weight[1, k]
                               + conv.bias[1, k])
                outs.append(h)
            return conv(g, g.x), torch.stack(outs).mean(0)
        if name == "SGConv":
            conv = tconv.SGConv(F, C, K=2)
            sl = np.concatenate([s, np.arange(n)])
            rl = np.concatenate([r, np.arange(n)])
            dis = np.bincount(rl, minlength=n).astype(np.float64) ** -0.5
            w = torch.from_numpy((dis[sl] * dis[rl]).astype(np.float32))
            h = x
            for _ in range(2):
                h = _scatter_add(h[_long(sl)] * w[:, None], rl, n)
            return conv(g, g.x), h @ conv.weight + conv.bias
        if name == "AGNNConv":
            conv = tconv.AGNNConv()
            conv.beta.data.fill_(1.3)
            sl = _long(np.concatenate([s, np.arange(n)]))
            rl = _long(np.concatenate([r, np.arange(n)]))
            xn = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-6)
            cos = (xn[sl] * xn[rl]).sum(-1) * 1.3
            mx = torch.full((n,), -1e30).index_reduce_(
                0, rl, cos, "amax", include_self=True)
            exv = torch.exp(cos - mx[rl])
            alpha = exv / _scatter_add(exv, rl, n).clamp(min=1e-16)[rl]
            return conv(g, g.x), _scatter_add(x[sl] * alpha[:, None], rl, n)
        if name == "NNConv":
            conv = tconv.NNConv(F, C, Dense(FE, F * C))
            ea = torch.from_numpy(a["edge_attr"])
            theta = conv.edge_nn(ea).view(-1, F, C)
            msgs = torch.einsum("ef,efc->ec", x[_long(s)], theta)
            return conv(g, g.x), _scatter_add(msgs, r, n) + x @ conv.root \
                + conv.bias
        if name == "SplineConv":
            conv = tconv.SplineConv(F, C, dim=1, kernel_size=3)
            u = torch.from_numpy(a["edge_attr"][:, 0])
            pos = u * 2
            k0 = pos.floor().clamp(max=2).long()
            frac = pos - k0.to(pos.dtype)
            k1 = (k0 + 1).clamp(max=2)
            xj = x[_long(s)]
            m = torch.einsum("ef,efc->ec", xj, conv.weight[k0]) \
                * (1 - frac)[:, None] \
                + torch.einsum("ef,efc->ec", xj, conv.weight[k1]) \
                * frac[:, None]
            return conv(g, g.x, pseudo=g.edge_attr[:, :1]), \
                _scatter_add(m, r, n) + x @ conv.root + conv.bias
        if name == "DNAConv":
            L, H, G = 3, 2, 2
            conv = tconv.DNAConv(F, heads=H, groups=G)
            for lin in (conv.lin_q, conv.lin_k, conv.lin_v):
                lin.bias.data.normal_()
            x_all = torch.from_numpy(np.random.default_rng(17).normal(
                size=(g.num_nodes, L, F)).astype(np.float32))
            xr = x_all[:n]
            q = conv.lin_q(xr[:, -1]).view(n, H, F // H)
            k = conv.lin_k(xr).view(n, L, H, F // H)
            v = conv.lin_v(xr).view(n, L, H, F // H)
            norm = tconv.gcn_norm(g)
            ns, nr, nw = (t.numpy() for t in (norm.senders, norm.receivers,
                                              norm.weights))
            real = (ns < n) & (nr < n) & (nw != 0)
            ns, nr, nw = ns[real], nr[real], nw[real]
            scores = torch.einsum("ehd,elhd->elh", q[_long(nr)],
                                  k[_long(ns)]) / math.sqrt(F // H)
            msg = torch.einsum("elh,elhd->ehd", torch.softmax(scores, 1),
                               v[_long(ns)]).reshape(-1, F)
            return conv(g, x_all), _scatter_add(
                msg * torch.from_numpy(nw)[:, None], nr, n)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["GraphConv", "GINConv", "SAGEConv",
                                  "ChebConv", "ARMAConv", "SGConv",
                                  "AGNNConv", "NNConv", "SplineConv",
                                  "DNAConv"])
def test_conv_matches_torch_oracle(name):
    g, _, a = _graphs(18, unique=True)
    torch.manual_seed(0)
    got, want = _oracle_case(name, g, a)
    n = a["x"].shape[0]
    assert bool(g.node_mask[:n].all()) and not bool(g.node_mask[n:].any())
    _close(got[:n], want.numpy(), 1e-5)


def test_pointconv_matches_torch_oracle():
    """The oracle's PointConv math on a fixed neighbourhood, every
    destination with at least one neighbour."""
    x, pos, pos_dst, s, r, _, n_dst = _point_inputs(19)
    r = np.arange(len(r)) % n_dst
    conv = tconv.PointConv(Dense(F + 3, 10), Dense(10, 7))
    t = torch.from_numpy
    with torch.no_grad():
        got = conv(t(x), (t(pos), t(pos_dst)), t(s), t(r), n_dst)
        rel = t(pos)[_long(s)] - t(pos_dst)[_long(r)]
        msg = conv.local_nn(torch.cat([t(x)[_long(s)], rel], dim=1))
        out = torch.full((n_dst, 10), -float("inf")).scatter_reduce(
            0, _long(r)[:, None].expand(-1, 10), msg, reduce="amax",
            include_self=True)
        want = conv.global_nn(out)
    _close(got, want.numpy(), 1e-5)
