"""Data parallelism (``parallel/mesh.py``, ``parallel/data_parallel.py``,
the DP examples, the driver's ``--gpus``) on gloo ranks against the JAX
package on its virtual CPU mesh.

One pool of 4 gloo ranks (``RankPool``) serves every case at P = 1, 2
and 4 (``test_torch_port_rank_cases.group_of``); the driver's ``--gpus
2`` starts a group of its own. The parent computes the JAX side: the
same synthetic graphs, the same weights (``convert.params_from_jax``).
Tolerance 1e-5 on these fp32 paths; the fixed-order average repeats
bitwise, run to run and rank to rank.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_port_rank_cases as cases
from pytorch_geometric_tpu.datasets.synthetic import (
    synthetic_graph_classification as j_synthetic)
from pytorch_geometric_tpu.models.graph_pred import (
    GraphClassifier as JGraphClassifier, graph_xent_loss as j_loss)
from pytorch_geometric_tpu.parallel import (
    DataParallelTrainer as JTrainer, make_mesh as j_make_mesh,
    shard_data_list as j_shard_data_list)
from pytorch_geometric_tpu.research import driver as jdriver
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.datasets.synthetic import (
    synthetic_graph_classification)
from pytorch_geometric_tpu_torch.parallel.mesh import RankPool
from pytorch_geometric_tpu_torch.research import driver

TOL = dict(rtol=1e-5, atol=1e-5)
BUDGETS = (128, 256, 2)            # nodes, edges, graphs per shard


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


def _jax_dp(P, datas, lr=0.1):
    """The JAX trainer on P virtual devices: params, grads, one SGD
    step's params and loss."""
    stacked = j_shard_data_list(datas, P, *BUDGETS)
    model = JGraphClassifier(hidden_channels=8, num_classes=3)
    g0 = jax.tree_util.tree_map(lambda a: a[0], stacked)
    params = model.init(jax.random.PRNGKey(0), g0)

    def loss_fn(p, graph, rng):
        return j_loss(model.apply(p, graph), graph.y, graph.graph_mask)

    mesh = j_make_mesh((P,), ("dp",), devices=jax.devices()[:P])
    trainer = JTrainer(mesh, loss_fn, optax.sgd(lr))
    key = jax.random.PRNGKey(1)
    grads = trainer.grads(params, stacked, key)
    p1, _, loss = trainer.step(params, trainer.init(params), stacked, key)
    return params, grads, p1, float(loss)


def _datas(P):
    port = synthetic_graph_classification(P * 2, 12, 6, 3, seed=0)
    ref = j_synthetic(P * 2, 12, 6, 3, seed=0)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
        np.testing.assert_array_equal(np.asarray(a.edge_index),
                                      np.asarray(b.edge_index))
    return port, ref


@pytest.mark.parametrize("P", [1, 2, 4])
def test_dp_grads_and_step_match_the_jax_trainer(pool, P):
    """The averaged gradients and one SGD step of ``DataParallelTrainer``
    against the JAX trainer's ``grads`` and ``step`` (1e-5), every rank
    with the same bits."""
    datas, jdatas = _datas(P)
    params, jgrads, jp1, jloss = _jax_dp(P, jdatas)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    kw = dict(in_channels=6, hidden_channels=8, num_classes=3)
    res = pool.run(cases.dp_case, P, datas, BUDGETS, state, kw, 0.1, 1)
    r0 = res[0]
    for r in res[1:P]:
        for a, b in zip(r["grads"], r0["grads"]):
            np.testing.assert_array_equal(a, b)
        for k in r0["state_dict"]:
            np.testing.assert_array_equal(r["state_dict"][k],
                                          r0["state_dict"][k])
    assert all(r is None for r in res[P:])
    names = list(r0["state_dict"])
    want_g = params_from_jax(jgrads)
    for name, g in zip(names, r0["grads"]):
        np.testing.assert_allclose(g, want_g[name].numpy(), err_msg=name,
                                   **TOL)
    want_p = params_from_jax(jp1)
    for name in names:
        np.testing.assert_allclose(r0["state_dict"][name],
                                   want_p[name].numpy(), err_msg=name, **TOL)
    np.testing.assert_allclose(float(r0["losses"][0]), jloss, **TOL)


def test_two_dp_runs_repeat_bitwise(pool):
    """Two runs of two steps at P = 4 give the same bits: the average
    adds the ranks in rank order, so no reduction order varies."""
    datas, _ = _datas(4)
    model = JGraphClassifier(hidden_channels=8, num_classes=3)
    stacked = j_shard_data_list(_datas(4)[1], 4, *BUDGETS)
    params = model.init(jax.random.PRNGKey(3),
                        jax.tree_util.tree_map(lambda a: a[0], stacked))
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    kw = dict(in_channels=6, hidden_channels=8, num_classes=3)
    runs = [pool.run(cases.dp_case, 4, datas, BUDGETS, state, kw, 0.1, 2)
            for _ in range(2)]
    for r in runs[0] + runs[1]:
        for a, b in zip(r["losses"], runs[0][0]["losses"]):
            assert a.tobytes() == b.tobytes()
        for k, v in r["state_dict"].items():
            assert v.tobytes() == runs[0][0]["state_dict"][k].tobytes()


def test_ordered_sum_adds_in_rank_order(pool):
    """``ordered_sum`` adds rank 0, 1, 2, 3 left to right: a sum whose
    float rounding depends on the order comes out as that order's."""
    values = np.array([[1.0], [1e8], [-1e8], [1e-3]], np.float32)
    res = pool.run(cases.ordered, values)
    want = ((values[0] + values[1]) + values[2]) + values[3]
    for r in res:
        assert r.tobytes() == want.tobytes()


def test_shard_data_list_is_the_jax_round_robin(pool):
    """Each rank's shard is ``data_list[rank::P]`` collated at the shard
    budget, as the JAX stack's row; a restack gives the stack back."""
    datas, jdatas = _datas(4)
    jstacked = j_shard_data_list(jdatas, 4, *BUDGETS)
    res = pool.run(cases.dp_stack_case, 4, datas, BUDGETS)
    for rank, (same, x, s, y) in enumerate(res):
        assert same
        np.testing.assert_array_equal(x, np.asarray(jstacked.x[rank]))
        np.testing.assert_array_equal(s, np.asarray(jstacked.senders[rank]))
        np.testing.assert_array_equal(y, np.asarray(jstacked.y[rank]))


def _jax_example_loss(P, datas):
    """The DP examples' loss semantics: the mean over the ranks of each
    shard's mean cross-entropy (JAX, one device a shard)."""
    from pytorch_geometric_tpu.data.batch import collate

    model = JGraphClassifier(hidden_channels=8, num_classes=3)
    g0 = collate(datas[:1], num_nodes=BUDGETS[0], num_edges=BUDGETS[1],
                 num_graphs=BUDGETS[2] + 1)
    params = model.init(jax.random.PRNGKey(5), g0)
    per = [float(j_loss(model.apply(params, g), g.y, g.graph_mask))
           for g in (collate(datas[i::P], num_nodes=BUDGETS[0],
                             num_edges=BUDGETS[1],
                             num_graphs=BUDGETS[2] + 1) for i in range(P))]
    return params, float(np.mean(per))


def test_dp_loss_is_the_mean_of_the_shard_means(pool):
    datas, jdatas = _datas(4)
    params, want = _jax_example_loss(4, jdatas)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    kw = dict(in_channels=6, hidden_channels=8, num_classes=3)
    res = pool.run(cases.dp_case, 4, datas, BUDGETS, state, kw, 0.0, 1)
    np.testing.assert_allclose(float(res[0]["losses"][0]), want, **TOL)


@pytest.mark.parametrize("module", ["data_parallel", "mnist_data_parallel"])
def test_dp_examples_run_on_four_ranks(pool, module):
    """Each DP example's rank function on the pool's 4 ranks, at a small
    size: finite losses, the same on every rank, and one set of weights."""
    args = (1, 0, "cpu") if module == "data_parallel" else \
        (1, 32, 128, 0, "cpu")
    res = pool.run(cases.run_example,
                   f"pytorch_geometric_tpu_torch.examples.{module}",
                   "train_rank", *args)
    losses = [r["step_losses"] for r in res]
    assert np.isfinite(losses[0]).all() and len(losses[0]) > 0
    for other in losses[1:]:
        assert other.tobytes() == losses[0].tobytes()
    if module == "data_parallel":
        for k, v in res[0]["state_dict"].items():
            for r in res[1:]:
                assert torch.equal(r["state_dict"][k], v), k


def test_gpus_flag_runs_on_two_cpu_ranks(tmp_path):
    """The driver's data-parallel graph classification (``--gpus 2``) on
    two gloo ranks, one epoch a phase: the JAX driver's widths, finite
    accuracies, rank 0's curves written."""
    (res,) = driver.training_net_graphcls(
        "MUTAG", num_layers=2, epochs=1, fine_tune_epochs=1, batch_size=32,
        num_devices=2, device="cpu", results_dir=str(tmp_path / "R"),
        ckpt_dir=str(tmp_path / "c"))
    assert res["widths"] == jdriver.contraction_layer_coefficients(
        128, 2, 0.5, seed=0)
    assert len(res["new_widths"]) == 2 and min(res["new_widths"]) >= 2
    for k in ("pretrain_best", "finetune_best"):
        assert 0.0 <= res[k] <= 1.0
    out = [p.name for p in (tmp_path / "R" / "MUTAGConvergence").iterdir()]
    assert any("TrainConvergence" in n for n in out)
    assert any("TestConvergence" in n for n in out)


def test_more_ranks_than_cards_raise(monkeypatch):
    """No fallback to gloo or the CPU: asking for more NCCL ranks than
    visible cards raises and names the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible"):
        RankPool(2, device="cuda")
    with pytest.raises(ValueError, match="1 visible"):
        driver.training_net_graphcls("MUTAG", num_devices=2)


def test_a_failing_rank_raises_in_the_caller(pool):
    """An exception in one rank is raised in the caller with its
    traceback, and the pool is shut down (the last test of the pool)."""
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one"):
        pool.run(cases.boom)
    assert not any(p.is_alive() for p in pool._procs)
