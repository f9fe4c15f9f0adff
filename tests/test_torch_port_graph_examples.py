"""Port parity, the graph-level examples: the model of each of
examples/mutag_gin.py, enzymes_topk_pool.py, enzymes_diff_pool.py,
qm9_nn_conv.py, autoencoder.py (GAE and VGAE) and infomax.py against the
JAX script's (loaded by path), from the same flax parameters
(``convert.params_from_jax`` with the example's ``FLAX_NAMES``), at a
small size: three steps of the port's training step, through the
batch's operators (the kernels' plain versions on the CPU), against the
JAX script's step and ``optax.adam`` over the same batches (each
package's loader, shuffled from one seed): every step's loss 1e-5, then
the logits 1e-4 and each parameter (and running statistic) 1e-4 in
relative L2. Dropout is off; the VGAE's noise and the infomax
corruption's permutation are the JAX draws, injected.

mutag_gin and enzymes_diff_pool take three SGD steps (``optax.sgd``;
mutag's lr 0.01, the script's, DiffPool's 0.1) in place of Adam: a bias right before a batch norm (mutag's
MLPs) or an L2 normalisation (DiffPool's ``DenseSAGEConv``) has a zero
gradient up to rounding, and Adam's first steps move each such entry by
±lr on the sign of that rounding, which differs between any two float32
implementations (the first step's loss and gradients agree; the
parameters then part by ~2 lr)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.data import DenseDataLoader as JDenseDataLoader
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.datasets import QM9 as JQM9
from pytorch_geometric_tpu.datasets import TUDataset as JTUDataset
from pytorch_geometric_tpu.nn.models import split_edges as j_split_edges
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import Distance as JDistance
from pytorch_geometric_tpu.transforms import ToDense as JToDense
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import (
    Data, DataLoader, DenseDataLoader, from_data)
from pytorch_geometric_tpu_torch.datasets import QM9, TUDataset
from pytorch_geometric_tpu_torch.examples import (
    autoencoder, enzymes_diff_pool, enzymes_topk_pool, infomax, mutag_gin,
    qm9_nn_conv)
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
from pytorch_geometric_tpu_torch.nn.models import VGAE, split_edges
from pytorch_geometric_tpu_torch.transforms import Compose, Distance, ToDense

REPO = Path(__file__).resolve().parents[1]
STEPS = 3


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _same_state(model, variables, names=None, rounding_only=()):
    """Each parameter and buffer of ``model`` within 1e-4 (relative L2)
    of the JAX variables'; those in ``rounding_only``, whose gradient is
    0 up to rounding (they start at 0 and hold that rounding), within
    1e-6 of 0 in both."""
    want = params_from_jax(variables, names)
    state = model.state_dict()
    assert sorted(want) == sorted(state)
    for name, b in want.items():
        a, b = state[name].numpy(), b.numpy()
        if name in rounding_only:
            assert np.abs(a).max() <= 1e-6 and np.abs(b).max() <= 1e-6
            continue
        assert np.linalg.norm(a - b) <= \
            1e-4 * max(np.linalg.norm(b), 1e-12), name


def _optimizer(lr, tx=None):
    tx = tx or optax.adam(lr)

    @jax.jit
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    return tx, step


def _synthetic(root, name):
    raw = root / name / "raw"
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")


def _graph_loss(logits, graph):
    logp = jax.nn.log_softmax(logits)
    y = graph.y.astype(jnp.int32)
    nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
    m = graph.graph_mask.astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)


def _tu_loaders(tmp_path, name, count=12, batch_size=4):
    _synthetic(tmp_path / "jax", name)
    port = TUDataset(str(tmp_path / "port"), name)[:count]
    ref = JTUDataset(str(tmp_path / "jax"), name)[:count]
    return (DataLoader(port, batch_size=batch_size, shuffle=True, seed=0,
                       device="cpu"),
            JDataLoader(ref, batch_size=batch_size, shuffle=True, seed=0))


# ---------------------------------------------------------------------------
# mutag_gin
# ---------------------------------------------------------------------------

def test_mutag_gin_three_steps_match_the_jax_script(tmp_path):
    loader, jloader = _tu_loaders(tmp_path, "MUTAG")
    jnet = _jax_example("mutag_gin").Net(hidden=32, num_classes=2)
    # the scripts shape the model on a first batch, which draws one
    # epoch's order: both loaders draw it
    next(iter(loader))
    variables = jnet.init(jax.random.PRNGKey(0), next(iter(jloader)))
    params, stats = variables["params"], variables["batch_stats"]
    net = mutag_gin.Net(7, 32, 2)
    net.load_state_dict(params_from_jax(variables, mutag_gin.FLAX_NAMES))
    tx, sgd = _optimizer(0.01, optax.sgd(0.01))
    state = tx.init(params)

    @jax.jit
    def value_and_grad(params, stats, graph):
        def loss_fn(p):
            logits, mut = jnet.apply({"params": p, "batch_stats": stats},
                                     graph, train=True,
                                     mutable=["batch_stats"])
            return _graph_loss(logits, graph), mut
        (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return loss, mut["batch_stats"], grads

    opt = torch.optim.SGD(net.parameters(), lr=0.01)
    ops = OperatorCache(mutag_gin.mutag_operators)
    batches = list(zip(loader.indexed(), jloader))
    assert len(batches) == STEPS
    for (idx, g), jg in batches:
        loss = mutag_gin.train_step(net, opt, g, ops(idx, g))
        want, stats, grads = value_and_grad(params, stats, jg)
        params, state = sgd(grads, state, params)
        _close(loss, want, 1e-5)
    # each MLP's second Dense bias feeds a batch norm, which removes it
    _same_state(net, {"params": params, "batch_stats": stats},
                mutag_gin.FLAX_NAMES,
                [f"conv{i}.mlp.Dense_1.bias" for i in range(1, 6)])
    (idx, g), jg = batches[0]
    with torch.no_grad():
        logits = net(g, **ops(idx, g))
    want = jnet.apply({"params": params, "batch_stats": stats}, jg)
    assert logits.shape == (g.num_graphs, 2)     # the padding graph's row
    _close(logits, want, 1e-4)


# ---------------------------------------------------------------------------
# enzymes_topk_pool
# ---------------------------------------------------------------------------

def test_enzymes_topk_pool_three_steps_match_the_jax_script(tmp_path):
    loader, jloader = _tu_loaders(tmp_path, "ENZYMES")
    jnet = _jax_example("enzymes_topk_pool").Net(num_classes=6, hidden=16)
    key = jax.random.PRNGKey(1)
    next(iter(loader))
    params = jnet.init({"params": key, "dropout": key},
                                next(iter(jloader)))
    net = enzymes_topk_pool.Net(3, 6, hidden=16)
    net.load_state_dict(params_from_jax(params))
    tx, adam = _optimizer(5e-4)
    state = tx.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, graph: _graph_loss(jnet.apply(p, graph), graph)))
    opt = torch.optim.Adam(net.parameters(), lr=5e-4)
    ops = OperatorCache(mutag_gin.mutag_operators)
    batches = list(zip(loader.indexed(), jloader))
    for (idx, g), jg in batches:
        loss = enzymes_topk_pool.train_step(net, opt, g, ops(idx, g),
                                            train=False)
        want, grads = value_and_grad(params, jg)
        params, state = adam(grads, state, params)
        _close(loss, want, 1e-5)
    _same_state(net, params)
    (idx, g), jg = batches[0]
    with torch.no_grad():
        logits = net(g, **ops(idx, g))
    _close(logits, jnet.apply(params, jg), 1e-4)


# ---------------------------------------------------------------------------
# enzymes_diff_pool
# ---------------------------------------------------------------------------

def test_enzymes_diff_pool_three_steps_match_the_jax_script(tmp_path):
    jmod = _jax_example("enzymes_diff_pool")
    _synthetic(tmp_path / "jax", "ENZYMES")
    # the script's pre-filter and pre-transform, over the first graphs
    # only (lists serve the dense loaders)
    port = [ToDense(jmod.MAX_NODES)(d) for d in
            TUDataset(str(tmp_path / "port"), "ENZYMES")[:16]
            if d.num_nodes <= jmod.MAX_NODES][:12]
    ref = [JToDense(jmod.MAX_NODES)(d) for d in
           JTUDataset(str(tmp_path / "jax"), "ENZYMES")[:16]
           if d.num_nodes <= jmod.MAX_NODES][:12]
    assert len(port) == len(ref) == 12
    loader = DenseDataLoader(port, batch_size=4, shuffle=True, seed=0,
                             device="cpu")
    jloader = JDenseDataLoader(ref, batch_size=4, shuffle=True, seed=0)
    jnet = jmod.DiffPoolNet(num_classes=6, hidden=16)
    next(iter(loader))
    b0 = next(iter(jloader))
    params = jnet.init(jax.random.PRNGKey(2), b0.x, b0.adj, b0.mask)
    net = enzymes_diff_pool.DiffPoolNet(3, 6, hidden=16)
    net.load_state_dict(params_from_jax(params))
    tx, sgd = _optimizer(0.1, optax.sgd(0.1))
    state = tx.init(params)

    def loss_fn(p, x, adj, mask, y):
        logits, ll, el = jnet.apply(p, x, adj, mask)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, y.astype(jnp.int32)[:, None], axis=1).mean()
        return nll + ll + el

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    batches = list(zip(loader, jloader))
    for b, jb in batches:
        loss = enzymes_diff_pool.train_step(net, opt, b)
        want, grads = value_and_grad(params, jb.x, jb.adj, jb.mask, jb.y)
        params, state = sgd(grads, state, params)
        _close(loss, want, 1e-5)
    _same_state(net, params)
    b, jb = batches[0]
    with torch.no_grad():
        logits, _, _ = net(b.x, b.adj, b.mask)
    _close(logits, jnet.apply(params, jb.x, jb.adj, jb.mask)[0], 1e-4)


# ---------------------------------------------------------------------------
# qm9_nn_conv
# ---------------------------------------------------------------------------

def test_qm9_nn_conv_three_steps_match_the_jax_script(tmp_path):
    jmod = _jax_example("qm9_nn_conv")
    port = QM9(str(tmp_path / "port"), transform=Compose(
        [qm9_nn_conv.Complete(), Distance(norm=False)]), num_synthetic=12)
    (tmp_path / "jax" / "qm9" / "raw").mkdir(parents=True)
    with pytest.warns(UserWarning, match="no network"):
        ref = JQM9(str(tmp_path / "jax"), transform=JCompose(
            [jmod.Complete(), JDistance(norm=False)]), num_synthetic=12)
    ys = np.stack([port.data_list[i].y[0] for i in range(len(port))])
    mean, std = float(ys[:, 0].mean()), float(ys[:, 0].std())
    loader = DataLoader(port, batch_size=4, shuffle=True, seed=0,
                        device="cpu")
    jloader = JDataLoader(ref, batch_size=4, shuffle=True, seed=0)
    jnet = jmod.Net(dim=16)
    next(iter(loader))
    params = jnet.init(jax.random.PRNGKey(3), next(iter(jloader)))
    net = qm9_nn_conv.Net(5, 5, dim=16)
    net.load_state_dict(params_from_jax(params, qm9_nn_conv.FLAX_NAMES))
    tx, adam = _optimizer(1e-3)
    state = tx.init(params)

    def loss_fn(p, graph):
        pred = jnet.apply(p, graph)
        target = (graph.y[:, 0] - mean) / (std + 1e-12)
        m = graph.graph_mask.astype(jnp.float32)
        return jnp.sum(((pred - target) ** 2) * m) / jnp.maximum(m.sum(), 1)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    ops = OperatorCache(qm9_nn_conv.qm9_operators)
    batches = list(zip(loader.indexed(), jloader))
    for (idx, g), jg in batches:
        loss = qm9_nn_conv.train_step(net, opt, g, ops(idx, g), mean, std)
        want, grads = value_and_grad(params, jg)
        params, state = adam(grads, state, params)
        _close(loss, want, 1e-5)
    _same_state(net, params, qm9_nn_conv.FLAX_NAMES)
    (idx, g), jg = batches[0]
    with torch.no_grad():
        pred = net(g, **ops(idx, g))
    _close(pred, jnet.apply(params, jg), 1e-4)


# ---------------------------------------------------------------------------
# autoencoder, infomax: a small citation-like graph
# ---------------------------------------------------------------------------

def _small_graph_arrays(seed=4, n=60, f=12, e=150):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = ei[:, ei[0] != ei[1]]
    ei = np.unique(np.concatenate([ei, ei[::-1]], 1), axis=1)
    x = rng.random((n, f)).astype(np.float32)
    return dict(x=x / x.sum(1, keepdims=True), edge_index=ei,
                y=rng.integers(0, 3, n), train_mask=np.arange(n) < 30,
                test_mask=np.arange(n) >= 30)


@pytest.mark.parametrize("variational", [False, True])
def test_autoencoder_three_steps_match_the_jax_script(variational):
    from pytorch_geometric_tpu.data import Data as JData

    jmod = _jax_example("autoencoder")
    arrays = _small_graph_arrays()
    data = split_edges(Data(**arrays), seed=0)
    jdata = j_split_edges(JData(**arrays), seed=0)
    g, jg = from_data(data, device="cpu"), j_from_data(jdata)
    enc_j = jmod.Encoder(out=4, variational=variational)
    params = enc_j.init(jax.random.PRNGKey(5), jg, jg.x)
    ae_j = (jmod.VGAE if variational else jmod.GAE)(None)
    pos_np = data.train_pos_edge_index
    neg_np = np.stack(jmod.negative_sampling(pos_np[0], pos_np[1], 60,
                                             pos_np.shape[1], seed=1))
    pos, neg = jnp.asarray(pos_np), jnp.asarray(neg_np)

    def loss_fn(p, key):
        if variational:
            mu, logstd = enc_j.apply(p, jg, jg.x)
            z = ae_j.reparametrize(mu, logstd, key)
            return ae_j.recon_loss(z, *pos, *neg) + \
                ae_j.kl_loss(mu, logstd) / jg.num_nodes
        return ae_j.recon_loss(enc_j.apply(p, jg, jg.x), *pos, *neg)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    enc = autoencoder.Encoder(12, out=4, variational=variational)
    enc.load_state_dict(params_from_jax(params))
    ae = (VGAE if variational else autoencoder.GAE)(enc)
    op, w = gcn_spmm_operator(g)
    aggregate_fn = op.bind(w)
    tpos = tuple(torch.from_numpy(a) for a in pos_np)
    tneg = tuple(torch.from_numpy(a) for a in neg_np)
    tx, adam = _optimizer(0.01)
    state = tx.init(params)
    opt = torch.optim.Adam(enc.parameters(), lr=0.01)
    key = jax.random.PRNGKey(6)
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.normal(
            sub, (g.num_nodes, 4)))) if variational else None
        opt.zero_grad()
        loss = autoencoder.loss_of(ae, enc, g, tpos, tneg, aggregate_fn,
                                   noise=noise)
        loss.backward()
        opt.step()
        want, grads = value_and_grad(params, sub)
        params, state = adam(grads, state, params)
        _close(loss, want, 1e-5)
    _same_state(enc, params)
    with torch.no_grad():
        z = enc(g, g.x, aggregate_fn)
    want = enc_j.apply(params, jg, jg.x)
    for a, b in zip(z if variational else [z],
                    want if variational else [want]):
        _close(a, b, 1e-4)


def test_infomax_three_steps_match_the_jax_script():
    from pytorch_geometric_tpu.data import Data as JData

    jmod = _jax_example("infomax")
    arrays = _small_graph_arrays(seed=7)
    g, jg = from_data(Data(**arrays), device="cpu"), \
        j_from_data(JData(**arrays))
    jnet = jmod.Model(hidden=16)
    key = jax.random.PRNGKey(8)
    params = jnet.init(key, jg, jg.x, key)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, k: jnet.apply(p, jg, jg.x, k), has_aux=True))
    perms = []

    def corruption(graph, x, rng):
        return graph, x[perms[-1]]

    net = infomax.Model(12, 16, corruption=corruption)
    net.load_state_dict(params_from_jax(params, infomax.FLAX_NAMES))
    op, w = gcn_spmm_operator(g)
    aggregate_fn = op.bind(w)
    tx, adam = _optimizer(1e-3)
    state = tx.init(params)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        # the JAX script's corruption: jax.random.permutation of its key
        perms.append(torch.from_numpy(np.array(
            jax.random.permutation(sub, g.num_nodes))))
        opt.zero_grad()
        loss, _ = net(g, g.x, None, aggregate_fn)
        loss.backward()
        opt.step()
        (want, _), grads = value_and_grad(params, sub)
        params, state = adam(grads, state, params)
        _close(loss, want, 1e-5)
    _same_state(net, params, infomax.FLAX_NAMES)
    with torch.no_grad():
        _, z = net(g, g.x, None, aggregate_fn)
    _close(z, jnet.apply(params, jg, jg.x, sub)[1], 1e-4)


# ---------------------------------------------------------------------------
# the kernels each step calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mutag_gin", "topk", "qm9"])
def test_each_step_calls_the_kernel_wrappers_chip_smoke_counts(
        name, monkeypatch):
    """The wrappers' calls of one training step and one evaluation batch
    equal the counts ``chip_smoke.py`` holds the card's launches to
    (mutag_gin: 5 GIN sums forward and 4 ``dx``, conv1's input taking
    none, and the readout's segment sum, its backward a gather;
    enzymes_topk_pool: 3 GraphConv sums and 2 ``dx``, a mean readout a
    level; qm9_nn_conv: NNConv's three message sums, Set2Set's two sums a
    step and its two gathers' backward sums). On the CPU the wrappers
    compute their plain versions and count no launch, so their calls are
    counted here."""
    import chip_smoke
    from pytorch_geometric_tpu_torch.ops import sorted_spmm, spmm

    calls = {}
    for module, fn in ((spmm, "spmm_csr"),
                       (sorted_spmm, "sorted_segment_sum")):
        orig = getattr(module, fn)

        def counted(*args, _orig=orig, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*args)

        monkeypatch.setattr(module, fn, counted)
    if name == "mutag_gin":
        step, evaluation = (chip_smoke.MUTAG_STEP_LAUNCHES,
                            chip_smoke.MUTAG_EVAL_LAUNCHES)
        train, _ = mutag_gin.load(batch_size=8, device="cpu")
        net, ops_fn, extra = mutag_gin.Net(), mutag_gin.mutag_operators, {}
        step_fn = mutag_gin.train_step
    elif name == "topk":
        step, evaluation = chip_smoke.GRAPH_EXAMPLES[name][2:]
        train, _ = enzymes_topk_pool.load(batch_size=8, device="cpu")
        net, ops_fn, extra = (enzymes_topk_pool.Net(3, 6, hidden=16),
                              mutag_gin.mutag_operators, {})
        step_fn = enzymes_topk_pool.train_step
    else:
        step, evaluation = chip_smoke.GRAPH_EXAMPLES[name][2:]
        train, _, mean, std = qm9_nn_conv.load(batch_size=2,
                                               num_samples=10, device="cpu")
        net, ops_fn = qm9_nn_conv.Net(dim=8), qm9_nn_conv.qm9_operators
        extra, step_fn = {"mean": mean, "std": std}, qm9_nn_conv.train_step
    idx, g = next(train.indexed())
    ops = OperatorCache(ops_fn)(idx, g)
    step_fn(net, torch.optim.Adam(net.parameters()), g, ops, **extra)
    assert calls == step
    calls.clear()
    with torch.no_grad():
        net(g, **ops)
    assert calls == evaluation
