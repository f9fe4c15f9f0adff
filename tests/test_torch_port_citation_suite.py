"""Port parity, the citation suite: the five models of
``pytorch_geometric_tpu_torch/examples/citation_suite.py`` (SGC, AGNN,
ARMA, Spline with ``TargetIndegree``, DNA) against examples/
citation_suite.py's, each as a whole model on a tiny padded graph drawn
from a numpy seed (DNA at a narrow width): the logits, then one AdamW
step's parameters against ``optax.adamw`` at the ``MODELS``
hyperparameters, dropout off (flax and torch draw different masks), with
the JAX ``model.init`` tree carried over unchanged by
``convert.params_from_jax``, through each model's operators and through
its plain CPU path. Tolerances: logits 1e-5 relative to the largest
reference magnitude, parameters after the step 1e-4 (relative to the
largest parameter). Then the port's
``train_suite`` on the CPU: its curve, no kernel launch, no set-up
launch."""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.models import citation as jcit
from pytorch_geometric_tpu.transforms import TargetIndegree as JTargetIndegree
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.examples import citation_suite as suite
from pytorch_geometric_tpu_torch.models.capture import launch_counts
from pytorch_geometric_tpu_torch.transforms import TargetIndegree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from examples import citation_suite as jsuite  # noqa: E402

F_IN, CLASSES = 12, 3
#: DNA at a narrow width: (hidden, layers, heads, groups).
DNA_SMALL = dict(hidden=16, num_layers=2, heads=2, groups=2)


def _arrays(seed, n=40, e=160):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return dict(x=rng.random((n, F_IN)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, CLASSES, n),
                train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.3,
                test_mask=rng.random(n) < 0.3)


def _graphs(name, seed=0):
    port, ref = Data(**_arrays(seed)), JData(**_arrays(seed))
    if name == "spline":
        port, ref = TargetIndegree()(port), JTargetIndegree()(ref)
    return from_data(port, device="cpu"), j_from_data(ref)


def _models(name):
    """The JAX model and the port's, dropout off on the port's side."""
    cls, _ = suite.MODELS[name]
    jcls, _ = jsuite.MODELS[name]
    off = {"sgc": {}, "arma": {"dropout_rate": 0.0, "conv_dropout": 0.0}}
    kw = off.get(name, {"dropout_rate": 0.0})
    if name == "dna":
        return jcls(num_classes=CLASSES, **DNA_SMALL), \
            cls(F_IN, CLASSES, **kw, **DNA_SMALL)
    return jcls(num_classes=CLASSES), cls(F_IN, CLASSES, **kw)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("path", ["operators", "plain"])
@pytest.mark.parametrize("name", sorted(suite.MODELS))
def test_suite_model_logits_and_one_adamw_step_match_jax(name, path):
    g, jg = _graphs(name)
    jmodel, model = _models(name)
    key = jax.random.PRNGKey(1)
    params = jmodel.init({"params": key, "dropout": key}, jg, jg.x)
    model.load_state_dict(params_from_jax(params), strict=True)
    ops = model.operators(g) if path == "operators" else {}
    with torch.no_grad():
        _close(model(g, g.x, **ops), jmodel.apply(params, jg, jg.x), 1e-5)

    hp = suite.MODELS[name][1]
    tx = optax.adamw(hp["lr"], weight_decay=hp["wd"])

    def loss_fn(p):
        logits = jmodel.apply(p, jg, jg.x, train=False)
        return jcit.masked_softmax_xent(logits, jg.y, jg.train_mask)

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = params_from_jax(optax.apply_updates(params, updates))
    step, evaluate = suite.create_train_step(model, g, hp["lr"], hp["wd"],
                                             ops)
    out = step(torch.Generator().manual_seed(0))
    _close(out["loss"], jloss, 1e-5)
    # relative to the largest parameter: DNA's key biases have a gradient
    # of 0 in exact arithmetic (the softmax over the history does not see
    # a shift common to every key), so both steps move them by rounding
    # noise / (|noise| + eps), a few 1e-6
    scale = max(float(w.abs().max()) for w in want.values())
    for pname, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[pname].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=pname)
    accs = evaluate()
    assert sorted(accs) == ["test_acc", "train_acc", "val_acc"]


def test_target_indegree_edge_attr_is_the_jax_packages():
    g, jg = _graphs("spline", 3)
    np.testing.assert_array_equal(g.edge_attr.numpy(),
                                  np.asarray(jg.edge_attr))


def test_suite_models_carry_the_flax_names():
    """Every JAX parameter path is a port parameter name (the suite's
    full widths), so ``params_from_jax`` needs no renaming."""
    for name in suite.MODELS:
        g, jg = _graphs(name, 4)
        jcls, _ = jsuite.MODELS[name]
        params = jcls(num_classes=CLASSES).init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(0)}, jg, jg.x)
        model = suite.MODELS[name][0](F_IN, CLASSES)
        want = {k: tuple(v.shape) for k, v in params_from_jax(params).items()}
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want, name


@pytest.mark.parametrize("name", sorted(suite.MODELS))
def test_train_suite_runs_on_the_cpu_without_launches(name):
    g, _ = _graphs(name, 5)
    before = launch_counts()
    model, metrics = suite.train_suite(name, g, CLASSES, epochs=3, seed=2,
                                       device="cpu")
    assert launch_counts() == before
    assert metrics["setup_launches"] == {} and "launches" not in metrics
    assert metrics["curve"]["loss"].shape == (3,)
    assert np.isfinite(metrics["curve"]["loss"]).all()
    assert all(0.0 <= metrics[f"{s}_acc"] <= 1.0
               for s in ("train", "val", "test"))
    # the trained model runs the same on its operators and on the plain path
    with torch.no_grad():
        _close(model(g, g.x, **model.operators(g)), model(g, g.x), 1e-5)
