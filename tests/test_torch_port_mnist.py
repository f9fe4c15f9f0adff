"""Port parity, the superpixel examples: examples/mnist_graclus.py,
mnist_voxel_grid.py and mnist_nn_conv.py against the JAX scripts (loaded
by path), on the same synthetic MNISTSuperpixels batches (each package's
dataset and loader, shuffled from one seed), at a small size:

- ``PrecomputeVoxelLevels`` bit for bit;
- the coarsened levels the port's host builds for a batch
  (``mnist_graclus.coarsened_levels``) against the JAX
  ``pool_graph_masked`` and ``device_cartesian``: edges and masks bit for
  bit, pooled positions and pseudo-coordinates 1e-6; level 2's readout
  rows routed by the mask;
- each script's model from the same flax parameters
  (``convert.params_from_jax``), three Adam steps (dropout off) through
  the batch's operators (the kernels' plain versions on the CPU) against
  the JAX step and ``optax.adam``: every loss 1e-5, then the logits 1e-4
  and each parameter 1e-4 in relative L2;
- on a meta tensor (the card's stand-in), level 1's convs and pools
  raise without their operators.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import MNISTSuperpixels as JMNIST
from pytorch_geometric_tpu.nn.pool import pool_graph_masked as j_pool
from pytorch_geometric_tpu.transforms import Cartesian as JCartesian
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms.coarsen_levels import (
    PrecomputeGraclusCoarsening as JGraclusLevels)
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.datasets import MNISTSuperpixels
from pytorch_geometric_tpu_torch.examples import (
    mnist_graclus, mnist_nn_conv, mnist_voxel_grid)
from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache
from pytorch_geometric_tpu_torch.nn.conv import NNConv, SplineConv
from pytorch_geometric_tpu_torch.nn.pool import (
    global_mean_pool, pool_graph_masked)

REPO = Path(__file__).resolve().parents[1]
SAMPLES, BATCH = 12, 4     # three train batches; test set 12 // 6


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", REPO / "examples" / f"{name}.py")
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


@pytest.fixture(scope="module")
def jmods():
    return {name: _jax_example(name) for name in
            ("mnist_graclus", "mnist_voxel_grid", "mnist_nn_conv")}


def _loaders(root, levels, jmods):
    """The port's and the JAX script's train loaders over the same
    synthetic graphs, after the epoch both scripts draw to shape the
    model."""
    if levels == "graclus":
        port, _ = mnist_graclus.load(0, BATCH, SAMPLES, root / "port",
                                     device="cpu")
        jpre = JCompose([JCartesian(), JGraclusLevels(levels=2)])
    else:
        port, _ = mnist_voxel_grid.load(0, BATCH, SAMPLES, root / "port",
                                        device="cpu")
        jpre = JCompose([JCartesian(),
                         jmods["mnist_voxel_grid"].PrecomputeVoxelLevels()])
    jds = JMNIST(str(root / "jax"), True, pre_transform=jpre,
                 num_synthetic=SAMPLES)
    ref = JDataLoader(jds, batch_size=BATCH, shuffle=True, seed=0)
    next(iter(port))
    next(iter(ref))
    return port, ref


def test_precompute_voxel_levels_is_the_jax_one_bit_for_bit(jmods,
                                                           tmp_path):
    port = MNISTSuperpixels(str(tmp_path / "port"), True, num_synthetic=6)
    ref = JMNIST(str(tmp_path / "jax"), True, num_synthetic=6)
    jtransform = jmods["mnist_voxel_grid"].PrecomputeVoxelLevels()
    transform = mnist_voxel_grid.PrecomputeVoxelLevels()
    for i in range(6):
        a, b = transform(port[i]), jtransform(ref[i])
        for k in ("cluster1", "cluster2"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert len(np.unique(a.cluster2)) < len(np.unique(a.cluster1)) < 75


@pytest.mark.parametrize("levels", ["graclus", "voxel"])
def test_host_built_levels_match_jax_pool_and_device_cartesian(
        levels, jmods, tmp_path):
    port, ref = _loaders(tmp_path, levels, jmods)
    device_cartesian = jmods["mnist_graclus"].device_cartesian
    for g, jg in zip(port, ref, strict=True):
        g1, g2 = mnist_graclus.coarsened_levels(g)
        jg1 = device_cartesian(j_pool(jg.extras["cluster1"], jg))
        jg2 = j_pool(jg.extras["cluster2"], jg1)
        for name in ("senders", "receivers", "edge_mask", "node_mask"):
            np.testing.assert_array_equal(_np(getattr(g1, name)),
                                          np.asarray(getattr(jg1, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(_np(g2.node_mask),
                                      np.asarray(jg2.node_mask))
        # duplicates kept, collapsed self loops masked off
        assert (_np(g1.senders) == _np(g1.receivers))[
            _np(g.edge_mask)].any()
        assert not (_np(g1.senders) == _np(g1.receivers))[
            _np(g1.edge_mask)].any()
        occupied = _np(g1.node_mask)
        np.testing.assert_allclose(_np(g1.pos)[occupied],
                                   np.asarray(jg1.pos)[occupied], atol=1e-6)
        kept = _np(g1.edge_mask)
        np.testing.assert_allclose(_np(g1.edge_attr)[kept],
                                   np.asarray(jg1.edge_attr)[kept],
                                   atol=1e-6)
        # level 2's readout routes its unoccupied rows to the padding graph
        ops = mnist_graclus.mnist_operators(g)
        mask2 = np.asarray(jg2.node_mask)
        want = np.where(mask2, np.asarray(jg2.batch), jg.num_graphs - 1)
        np.testing.assert_array_equal(_np(ops["readout"].receivers), want)


def _steps(model, jnet, loaders, build, names=None):
    """Three Adam steps of the port's step and the JAX script's (dropout
    off), then the logits on the first batch and the parameters."""
    port, ref = loaders
    batches = list(zip(port.indexed(), ref))
    assert len(batches) == 3
    key = jax.random.PRNGKey(7)
    params = jnet.init({"params": key, "dropout": key}, batches[0][1])
    model.load_state_dict(params_from_jax(params, names))
    tx = optax.adam(0.01)
    state = tx.init(params)

    @jax.jit
    def step(params, state, graph):
        def loss_fn(p):
            logits = jnet.apply(p, graph)
            logp = jax.nn.log_softmax(logits)
            y = graph.y.astype(jnp.int32)
            nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
            m = graph.graph_mask.astype(jnp.float32)
            return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    ops = OperatorCache(build)
    for (idx, g), jg in batches:
        loss = mnist_graclus.train_step(model, opt, g, ops(idx, g),
                                        train=False)
        params, state, want = step(params, state, jg)
        _close(loss, want, 1e-5)
    (idx, g), jg = batches[0]
    with torch.no_grad():
        logits = model(g, ops=ops(idx, g))
    assert logits.shape == (g.num_graphs, 10)
    _close(logits, jnet.apply(params, jg), 1e-4)
    want = params_from_jax(params, names)
    state = model.state_dict()
    assert sorted(want) == sorted(state)
    for name, b in want.items():
        a, b = state[name].numpy(), b.numpy()
        assert np.linalg.norm(a - b) <= \
            1e-4 * max(np.linalg.norm(b), 1e-12), name


@pytest.mark.parametrize("name", ["mnist_graclus", "mnist_voxel_grid",
                                  "mnist_nn_conv"])
def test_model_three_steps_match_the_jax_script(name, jmods, tmp_path):
    levels = "graclus" if name == "mnist_graclus" else "voxel"
    loaders = _loaders(tmp_path, levels, jmods)
    if name == "mnist_nn_conv":
        _steps(mnist_nn_conv.Net(), jmods[name].Net(), loaders,
               mnist_nn_conv.nn_conv_operators, mnist_nn_conv.FLAX_NAMES)
    else:
        # the voxel script trains mnist_graclus's Net
        _steps(mnist_graclus.Net(), jmods["mnist_graclus"].Net(), loaders,
               mnist_graclus.mnist_operators)


def test_plain_forward_equals_the_operator_forward(jmods, tmp_path):
    """Without operators (the CPU's plain segment ops and the level
    geometry from the device functions) the forward equals the one
    through the batch's operators, for both models (1e-5)."""
    port, _ = _loaders(tmp_path, "voxel", jmods)
    idx, g = next(iter(port.indexed()))
    gen = torch.Generator().manual_seed(0)
    for model, build in ((mnist_graclus.Net(generator=gen),
                          mnist_graclus.mnist_operators),
                         (mnist_nn_conv.Net(generator=gen),
                          mnist_nn_conv.nn_conv_operators)):
        with torch.no_grad():
            _close(model(g, ops=build(g)), model(g), 1e-5)


def test_level_one_sums_raise_on_a_card_without_their_operators(
        jmods, tmp_path):
    """A meta tensor stands for the card: level 1's SplineConv, NNConv
    and pools, and level 2's readout, refuse to sum feature rows by plain
    segment ops there."""
    port, _ = _loaders(tmp_path, "graclus", jmods)
    g = next(iter(port))
    g1, g2 = mnist_graclus.coarsened_levels(g)
    meta1 = g1.to("meta")
    x = torch.zeros((g1.num_nodes, 32), device="meta")
    with pytest.raises(ValueError, match="spline_op"):
        SplineConv(32, 64, dim=2, kernel_size=5)(meta1, x)
    conv = NNConv(32, 64, mnist_nn_conv.EdgeNN(2, 32 * 64), aggr="mean")
    with pytest.raises(ValueError, match="segment_op"):
        conv.to("meta")(meta1, x)
    with pytest.raises(ValueError, match="cluster_operator"):
        pool_graph_masked(meta1.extras["cluster2"], meta1.replace(x=x))
    meta2 = g2.to("meta")
    with pytest.raises(ValueError, match="pool_operator"):
        global_mean_pool(torch.zeros((g2.num_nodes, 64), device="meta"),
                         meta2)
