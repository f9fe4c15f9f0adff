"""Port parity, examples/pointnet2.py: ``PrecomputeSetAbstraction`` bit for
bit against the JAX script's, the collated batches' stacked, offset index
fields against the JAX loader's, and the model from the same flax
parameters (``convert.params_from_jax``) for three steps of the script's
training step against the JAX step (every loss 1e-5, then the logits
1e-4 and each parameter 1e-4 in relative L2), on the synthetic ModelNet10
at two samples a class. The path has no kernel of the port: its maxima
are torch's ``scatter_reduce`` in both directions, as in JAX.

The steps are SGD (lr 0.1; ``optax.sgd`` against ``torch.optim.SGD``),
not the script's Adam: the ReLU MLPs under the maxima leave thousands of
weights with a gradient of rounding only (|g| < 1e-7 of a largest 0.15),
and Adam's first steps move each by +-lr on the sign of that rounding,
which differs between any two float32 implementations (the first step's
gradients agree to 4e-7 in relative L2; after three Adam steps a bias
parts by 9e-3)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import ModelNet as JModelNet
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import NormalizeScale as JNormalize
from pytorch_geometric_tpu.transforms import SamplePoints as JSample
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.examples import pointnet2

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("cluster_sa1_idx", "sa1_sel_mask", "cluster_sa1_src",
          "cluster_sa1_dst", "sa1_edge_mask", "cluster_sa2_idx",
          "sa2_sel_mask", "cluster_sa2_src", "cluster_sa2_dst",
          "sa2_edge_mask")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "reference_examples_pointnet2", REPO / "examples" / "pointnet2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _loaders(tmp_path, jmod, batch_size=8):
    port, _ = pointnet2.load(0, batch_size, 2, tmp_path / "port",
                             device="cpu")
    jpre = JCompose([JNormalize(), JSample(jmod.N_POINTS),
                     jmod.PrecomputeSetAbstraction()])
    jds = JModelNet(str(tmp_path / "jax"), "10", True, pre_transform=jpre,
                    samples_per_class=2)
    return port, JDataLoader(jds, batch_size=batch_size, shuffle=True,
                             seed=0)


def test_precompute_set_abstraction_and_batches_match_the_jax_script(
        tmp_path):
    jmod = _jax_script()
    assert (pointnet2.N_POINTS, pointnet2.SA1_K, pointnet2.SA1_R,
            pointnet2.SA1_RATIO, pointnet2.SA2_K, pointnet2.SA2_R,
            pointnet2.SA2_RATIO) == (jmod.N_POINTS, jmod.SA1_K, jmod.SA1_R,
                                     jmod.SA1_RATIO, jmod.SA2_K, jmod.SA2_R,
                                     jmod.SA2_RATIO)
    port, ref = _loaders(tmp_path, jmod)
    for i in range(len(port.dataset)):
        a, b = port.dataset[i], ref.dataset[i]
        np.testing.assert_array_equal(a.pos, b.pos)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
    for g, jg in zip(port, ref, strict=True):
        for k in FIELDS:
            got, want = _np(g.extras[k]), np.asarray(jg.extras[k])
            assert got.shape == want.shape and got.ndim == 2   # (G, budget)
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_pointnet2_three_steps_match_the_jax_script(tmp_path):
    jmod = _jax_script()
    port, ref = _loaders(tmp_path, jmod)
    next(iter(port))
    next(iter(ref))
    batches = list(zip(port, ref))
    assert len(batches) == 3
    jnet = jmod.Net()
    params = jnet.init(jax.random.PRNGKey(3), batches[0][1])
    model = pointnet2.Net()
    model.load_state_dict(params_from_jax(params))
    tx = optax.sgd(0.1)
    state = tx.init(params)

    @jax.jit
    def step(params, state, graph):
        def loss_fn(p):
            logp = jax.nn.log_softmax(jnet.apply(p, graph))
            y = graph.y.astype(jnp.int32)
            nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
            m = graph.graph_mask.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for g, jg in batches:
        loss = pointnet2.train_step(model, opt, g)
        params, state, want = step(params, state, jg)
        _close(loss, want, 1e-5)
    g, jg = batches[0]
    with torch.no_grad():
        logits = model(g)
    assert logits.shape == (g.num_graphs, 10)
    _close(logits, jnet.apply(params, jg), 1e-4)
    want = params_from_jax(params)
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for name, b in want.items():
        a, b = got[name].numpy(), b.numpy()
        assert np.linalg.norm(a - b) <= \
            1e-4 * max(np.linalg.norm(b), 1e-12), name
