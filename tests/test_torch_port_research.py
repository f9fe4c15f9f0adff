"""Port parity, the research library: ``research/pruning.py``,
``models/prunable.py``, ``research/link_prediction.py`` and
``research/checkpoint.py`` against the JAX package, on the same
numpy inputs, with weights carried by ``convert.params_from_jax``.

- widths, SVD cutoffs and ``retain_network_size`` bitwise, for every zoo
  model and for an 11-layer GCN (``layers_10`` walks before
  ``layers_2``);
- each zoo model's output (1e-5) and parameter gradients (1e-4,
  relative to the model's largest gradient) with dropout off, through
  its operators and through its plain CPU path (the JAX GAT on its
  segment path); without its operators each raises on a
  card (a meta tensor stands for it);
- the seven scorers on the same graphs (1e-12) and the missing
  ``community`` error;
- a checkpoint round trip read back with ``weights_only``.

ADMM, quantization, Fiedler SGD and the spectral clustering are in
``test_torch_port_admm.py``."""

import jax
import networkx as nx
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.data.batch import collate as j_collate
from pytorch_geometric_tpu.models import prunable as jprunable
from pytorch_geometric_tpu.research import link_prediction as jlp
from pytorch_geometric_tpu.research import pruning as jpruning
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.data.batch import collate
from pytorch_geometric_tpu_torch.models import prunable
from pytorch_geometric_tpu_torch.research import link_prediction as lp
from pytorch_geometric_tpu_torch.research import pruning
from pytorch_geometric_tpu_torch.research.checkpoint import CheckpointManager
from pytorch_geometric_tpu_torch.research.spectral import WeightGraph

F_IN, CLASSES = 10, 3
WIDTHS = (9, 6)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _citation_arrays(seed=0, n=30, e=120):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return dict(x=rng.random((n, F_IN)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


def _batch_arrays(seed=0, count=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 12))
        ei = np.stack([rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)])
        out.append(dict(x=rng.normal(size=(n, F_IN)).astype(np.float32),
                        edge_index=np.concatenate([ei, ei[::-1]], 1),
                        y=np.int64(rng.integers(0, CLASSES))))
    return out


def _graphs(name):
    """``(port graph, JAX graph)`` of the model's kind of input."""
    if name == "TopK":
        arrays = _batch_arrays()
        return (collate([Data(**a) for a in arrays], device="cpu"),
                j_collate([JData(**a) for a in arrays]))
    a = _citation_arrays()
    return from_data(Data(**a), device="cpu"), j_from_data(JData(**a))


_JAX = {}


def _models(name, widths=WIDTHS):
    """The JAX model, its variables (built once a module) and a fresh
    port model carrying them, dropout off."""
    off = {} if name == "TopK" else {"dropout": 0.0}
    g, jg = _graphs(name)
    if (name, widths) not in _JAX:
        jmodel = jprunable.choose_model(name, widths, CLASSES, **off)
        key = jax.random.PRNGKey(3)
        args = (jg,) if name == "TopK" else (jg, jg.x)
        _JAX[name, widths] = jmodel, jax.jit(jmodel.init)(
            {"params": key, "dropout": key}, *args)
    jmodel, params = _JAX[name, widths]
    model = prunable.choose_model(name, widths, CLASSES, in_channels=F_IN,
                                  **off)
    model.load_state_dict(params_from_jax(params), strict=True)
    return g, jg, jmodel, params, model


def _forward(model, g, ops):
    if isinstance(model, prunable.PrunableTopK):
        return model(g, **ops)
    return model(g, g.x, **ops)


def test_contraction_widths_and_cutoffs_match_jax():
    for args in ((1433, 2, 0.5, 0), (128, 3, 0.5, 4), (50, 5, 0.3, 7),
                 (3, 2, 0.9, 1)):
        assert pruning.contraction_layer_coefficients(*args) == \
            jpruning.contraction_layer_coefficients(*args)
    rng = np.random.default_rng(0)
    for _ in range(5):
        d = np.sort(rng.random(12))[::-1] * 10
        for c in (0.6, 1.0, 1.3, 2.0):
            assert pruning.find_cutoff_point(d, c) == \
                jpruning.find_cutoff_point(d, c)


@pytest.mark.parametrize("name", sorted(prunable.MODEL_ZOO))
def test_retain_network_size_matches_jax(name):
    _, _, _, params, model = _models(name)
    for con in (0.6, 1.05, 1.5):
        want = jpruning.retain_network_size(params, con)
        assert pruning.retain_network_size(model, con) == want
        assert pruning.retain_network_size(model.state_dict(), con) == want
    # the walk's names and order are flax's
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = ["/".join(str(p.key) for p in path) for path, _ in flat]
    assert [n for n, _ in pruning.param_items(model)] == names


def test_retain_network_size_walks_layers_10_before_layers_2():
    widths = tuple(range(20, 9, -1))           # 11 hidden layers
    _, _, _, params, model = _models("GCN", widths)
    names = [n for n, _ in pruning.param_items(model)]
    assert names.index("params/layers_10/weight") < \
        names.index("params/layers_2/weight")
    for con in (0.6, 1.02, 1.1):
        assert pruning.retain_network_size(model, con) == \
            jpruning.retain_network_size(params, con)


@pytest.mark.parametrize("path", ["operators", "plain"])
@pytest.mark.parametrize("name", sorted(prunable.MODEL_ZOO))
def test_zoo_model_output_and_gradients_match_jax(name, path):
    g, jg, jmodel, params, model = _models(name)
    args = (jg,) if name == "TopK" else (jg, jg.x)
    shape = jax.eval_shape(jmodel.apply, params, *args).shape
    R = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    def loss_fn(p):
        return (jmodel.apply(p, *args) * R).sum()

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ops = model.operators(g) if path == "operators" else {}
    out = _forward(model, g, ops)
    _close(out, jax.jit(jmodel.apply)(params, *args), 1e-5)
    (out * torch.from_numpy(R)).sum().backward()
    # relative to the model's largest gradient: a parameter whose
    # gradient is 0 in exact arithmetic (the last GAT layer's att_dst: a
    # receiver's softmax does not see its own shift) holds rounding only
    jg_flat = params_from_jax(grads)
    scale = max(float(np.abs(v.numpy()).max()) for v in jg_flat.values())
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(_np(p.grad), jg_flat[pname].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", sorted(prunable.MODEL_ZOO))
def test_zoo_model_without_its_operators_raises_on_a_card(name):
    g, _, _, _, model = _models(name)
    meta = g.replace(x=torch.empty(g.x.shape, device="meta"))
    with pytest.raises(ValueError, match="not summed by plain segment ops"):
        _forward(model, meta, {})


def test_choose_model_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="not in zoo"):
        prunable.choose_model("MLP", WIDTHS, CLASSES, in_channels=F_IN)


def _scorer_graphs(seed):
    rng = np.random.default_rng(seed)
    G = nx.gnm_random_graph(14, 30, seed=seed)
    W = WeightGraph()
    W.add_nodes_from(G.nodes())
    for u, v in G.edges():
        w = float(rng.normal())
        G[u][v]["weight"] = w
        W.add_edge(u, v, w)
    for u in G.nodes():
        c = int(rng.integers(0, 3))
        G.nodes[u]["community"] = c
        W.nodes[u]["community"] = c
    return G, W


@pytest.mark.parametrize("method", sorted(lp.METHODS))
def test_scorers_match_jax(method):
    for seed in range(3):
        G, W = _scorer_graphs(seed)
        pairs = [(u, v) for u in range(14) for v in range(u + 1, 14)][::3]
        got = list(lp.METHODS[method](W, pairs))
        want = list(jlp.METHODS[method](G, pairs))
        assert [(u, v) for u, v, _ in got] == [(u, v) for u, v, _ in want]
        np.testing.assert_allclose([s for _, _, s in got],
                                   [s for _, _, s in want], rtol=1e-12,
                                   atol=1e-12)
        # every non-edge, through networkx on the host
        got = sorted(lp.METHODS[method](W))
        want = sorted(jlp.METHODS[method](G))
        assert [p[:2] for p in got] == [p[:2] for p in want]
        np.testing.assert_allclose([p[2] for p in got],
                                   [p[2] for p in want], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("method", ["cn_soundarajan_hopcroft",
                                    "ra_index_soundarajan_hopcroft",
                                    "within_inter_cluster"])
def test_community_scorers_need_the_attribute(method):
    W = WeightGraph()
    W.add_edge(0, 1, 1.0)
    W.add_edge(1, 2, 1.0)
    with pytest.raises(ValueError, match="no 'community' attribute"):
        list(lp.METHODS[method](W, [(0, 2)]))
    with pytest.raises(ValueError, match="delta"):
        list(lp.within_inter_cluster(W, [(0, 2)], delta=0.0))


def test_checkpoint_round_trip_with_weights_only(tmp_path):
    g, _, _, _, model = _models("GCN")
    opt = torch.optim.AdamW(model.parameters(), lr=0.01)
    model(g, g.x).sum().backward()
    opt.step()
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.path("k").endswith("k-ckpt.pt")
    params_, opt_ = model.state_dict(), opt.state_dict()
    assert ckpt.save_best("k", 0.5, params_, opt_, [1.0, 0.5], [0.3],
                          epoch=7, extra={"widths": [9, 6]})
    assert not ckpt.save_best("k", 0.5, params_, opt_)     # not better
    assert not ckpt.save_best("k", 0.4, params_, opt_)
    params, opt_state, tr, te, metric, epoch = ckpt.resume("k")
    assert (tr, te, metric, epoch) == ([1.0, 0.5], [0.3], 0.5, 7)
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v)
    fresh = torch.optim.AdamW(model.parameters(), lr=0.01)
    fresh.load_state_dict(opt_state)
    for p in model.parameters():
        assert torch.equal(fresh.state[p]["exp_avg"],
                           opt.state[p]["exp_avg"])
    raw = torch.load(ckpt.path("k"), weights_only=True)
    assert raw["extra"] == {"widths": [9, 6]}
    assert ckpt.save_best("k", 0.9, model.state_dict(), opt.state_dict())
    assert ckpt.load("k")["metric"] == 0.9
    assert ckpt.resume("absent") is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["k-ckpt.pt"]
