"""The distributed nn API (``parallel/api.py``, ``parallel/models.py``,
the convs' ``shard_ctx`` paths, examples/distributed_gcn.py and the
driver's ``--partition``) on gloo ranks against the JAX package's
``GraphPartition`` and Dist models on its virtual CPU mesh.

One pool of 4 gloo ranks serves the model cases at P = 4 (the JAX
tests' size); the driver's ``--partition 2`` starts a group of its own. The weights are the JAX model's (``convert.params_from_jax``).
Tolerances: GAT and RGCN (fp32 paths) 1e-5; GCN and SAGE aggregate
through the bf16 ``PartitionedSpmm``: 2e-2 relative L2 (forward and
loss) and 5e-2 (the step's parameter change).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import test_torch_port_rank_cases as cases
from pytorch_geometric_tpu.parallel.api import (
    GraphPartition as JGraphPartition)
from pytorch_geometric_tpu.parallel import models as jmodels
from pytorch_geometric_tpu.research import driver as jdriver
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.parallel.api import GraphPartition
from pytorch_geometric_tpu_torch.parallel.mesh import RankPool
from pytorch_geometric_tpu_torch.research import driver

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(window=64, dense_threshold=48)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


def _problem(seed=0, N=300, E=2400, F=10, C=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    x = rng.normal(size=(N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    return src, dst, x, y, N, C


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_part(src, dst, N, P, **kw):
    return JGraphPartition(src, dst, N, P, sparse_tile=128,
                           devices=jax.devices()[:P], **dict(KW, **kw))


def _jax_forward(part, model, x, seed):
    x_sh = part.shard_nodes(x)
    params = part.init_model(model, x_sh, jax.random.PRNGKey(seed))
    return params, part.unshard_nodes(part.apply_model(model, params, x_sh))


MODELS = {
    # name: (JAX model, port kwargs beyond in_channels, fp32 path)
    "DistGCN": (lambda C: jmodels.DistGCN(hidden_channels=8, num_classes=C),
                lambda C: dict(hidden_channels=8, num_classes=C), False),
    "DistSAGE": (lambda C: jmodels.DistSAGE(hidden_channels=8,
                                            num_classes=C),
                 lambda C: dict(hidden_channels=8, num_classes=C), False),
    "DistGAT": (lambda C: jmodels.DistGAT(num_classes=C, hidden_channels=6,
                                          heads=3),
                lambda C: dict(num_classes=C, hidden_channels=6, heads=3),
                True),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dist_model_forward_matches_the_jax_one(pool, name):
    P = 4
    src, dst, x, _, N, C = _problem(seed=2)
    jmodel, port_kw, fp32 = MODELS[name]
    params, want = _jax_forward(_jax_part(src, dst, N, P), jmodel(C), x, 2)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    res = pool.run(cases.dist_forward, P, src, dst, N, KW, name,
                   dict(in_channels=x.shape[1], **port_kw(C)), state, x)
    for r in res[:P]:
        np.testing.assert_array_equal(r, res[0])    # gathered on each rank
    if fp32:
        np.testing.assert_allclose(res[0], want, **TOL)
    else:
        assert _rel_l2(res[0], want) < 2e-2


def test_dist_rgcn_forward_matches_the_jax_one(pool):
    rng = np.random.default_rng(8)
    N, E, R, F, C = 220, 1500, 4, 6, 3
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    et = rng.integers(0, R, len(src))
    x = rng.normal(size=(N, F)).astype(np.float32)
    kw = dict(edge_type=et, num_relations=R)
    model = jmodels.DistRGCN(hidden_channels=5, num_classes=C,
                             num_relations=R, num_bases=2)
    params, want = _jax_forward(_jax_part(src, dst, N, 4, **kw), model, x, 4)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    res = pool.run(cases.dist_forward, 4, src, dst, N, dict(KW, **kw),
                   "DistRGCN", dict(in_channels=F, hidden_channels=5,
                                    num_classes=C, num_relations=R,
                                    num_bases=2), state, x)
    np.testing.assert_allclose(res[0], want, **TOL)


def _nll_terms(logits, y_l, m_l):
    logp = jax.nn.log_softmax(logits)
    oh = (y_l[:, None] == jnp.arange(logits.shape[-1])[None, :])
    nll = -jnp.sum(logp * oh.astype(logp.dtype), axis=1)
    return jnp.sum(nll * m_l), jnp.sum(m_l)


def test_dist_gcn_train_step_matches_the_jax_one(pool):
    """One SGD step of ``make_train_step`` (dropout 0) against the JAX
    step: the loss and each parameter's change."""
    src, dst, x, y, N, C = _problem(seed=3)
    part = _jax_part(src, dst, N, 4)
    model = jmodels.DistGCN(hidden_channels=8, num_classes=C,
                            dropout_rate=0.0)
    x_sh = part.shard_nodes(x)
    params = part.init_model(model, x_sh, jax.random.PRNGKey(3))
    tx = optax.sgd(0.1)
    mask = (np.arange(N) % 3 == 0).astype(np.float32)
    step = part.make_train_step(model, tx, _nll_terms)
    new, _, loss = step(params, tx.init(params), x_sh, part.shard_nodes(y),
                        part.shard_nodes(mask), jax.random.PRNGKey(0))
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    res = pool.run(cases.dist_train_step, 4, src, dst, N, KW, "DistGCN",
                   dict(in_channels=x.shape[1], hidden_channels=8,
                        num_classes=C, dropout_rate=0.0), state, x, y, mask,
                   0.1, 1)
    losses, got = res[0]
    assert abs(losses[0] - float(loss)) / float(loss) < 2e-2
    want = params_from_jax(new)
    for k, v in got.items():
        for r in res[1:]:
            np.testing.assert_array_equal(r[1][k], v)
        assert _rel_l2(v - state[k], want[k].numpy() - state[k]) < 5e-2, k


def test_preexisting_self_loops_are_dropped_before_the_appended_ones():
    """Remove-then-add: an edge list with self loops partitions to the
    same weights and tables as the one without."""
    src, dst, _, _, N, _ = _problem(seed=5)
    loops = np.arange(0, N, 3)
    a = GraphPartition(src, dst, N, 4, device="cpu", **KW)
    b = GraphPartition(np.concatenate([src, loops]),
                       np.concatenate([dst, loops]), N, 4, device="cpu",
                       **KW)
    for f in ("loc_src_row", "loc_dst", "rem_dst", "halo_send_idx"):
        np.testing.assert_array_equal(getattr(a.shards, f),
                                      getattr(b.shards, f))
    for p in range(4):
        for k in ("gcn", "mean"):
            ca, cb = a.stacked_consts()[p][k], b.stacked_consts()[p][k]
            for which in ("fwd", "bwd"):
                np.testing.assert_array_equal(
                    ca["remote"][which].numpy(), cb["remote"][which].numpy())


def test_partition_builds_the_operators_of_every_rank_without_a_group():
    """Outside a group (one process holding every shard, as the card's
    ``partition_shards`` phase) every rank's tables and operators are
    built, and the GraphPartition's comm_stats count each path in the
    width it moves: bf16 for the SpMM, fp32 for halo_gat."""
    src, dst, _, _, N, _ = _problem(seed=6)
    part = GraphPartition(src, dst, N, 4, device="cpu", **KW)
    jpart = _jax_part(src, dst, N, 4)
    assert part.group is None and sorted(part.stacked_consts()) == [0, 1, 2,
                                                                     3]
    assert part.ops["gcn"].num_dense_blocks == \
        jpart.ops["gcn"].num_dense_blocks
    assert part.comm_stats(16) == jpart.comm_stats(16)
    assert part.comm_stats(16, path="gat") == \
        jpart.shards.comm_stats(16, dtype_bytes=4)
    assert part.comm_stats(16, dtype_bytes=4) == \
        jpart.comm_stats(16, dtype_bytes=4)
    with pytest.raises(ValueError, match="link bandwidth"):
        GraphPartition.predict_scaling(10 ** 6, 16, 10 ** 5, 4, 1e9)
    kw = dict(local_edge_frac=0.7, exchanges_per_step=4)
    assert GraphPartition.predict_scaling(
        10 ** 6, 16, 10 ** 5, 4, 1e9, ici_GBps=50.0, **kw) == \
        JGraphPartition.predict_scaling(10 ** 6, 16, 10 ** 5, 4, 1e9,
                                        ici_GBps=50.0, **kw)


def test_distributed_gcn_example_on_four_ranks(pool):
    """examples/distributed_gcn.py's rank function on 4 ranks, 6 epochs:
    the loss falls, every rank ends with the same weights and logits."""
    from pytorch_geometric_tpu_torch.examples import distributed_gcn

    graph = distributed_gcn.load(0)
    res = pool.run(cases.run_example,
                   "pytorch_geometric_tpu_torch.examples.distributed_gcn",
                   "train_rank", graph, 6, 16, 0, 4, "cpu")
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    for r in res[1:]:
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])
        assert r["losses"].tobytes() == res[0]["losses"].tobytes()
    assert 0.0 <= res[0]["test"] <= 1.0


def test_partition_flag_matches_the_jax_driver_on_two_ranks(tmp_path,
                                                             monkeypatch):
    """The driver's ``--partition 2`` with GAT (fp32, no dropout) from
    the JAX driver's initial weights, on synthetic Cora (both packages
    draw it from the process's string hash, so it is loaded here and
    handed to the ranks): its first and last loss and accuracies against
    the JAX ``training_net_partitioned``."""
    raw = tmp_path / "jax" / "Cora" / "raw"
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")
    load = jdriver.load_citation_dataset
    monkeypatch.setattr(jdriver, "load_citation_dataset",
                        lambda name: load(name, str(tmp_path / "jax")))
    ds, graph = jdriver.load_citation_dataset("Cora")
    emask = np.asarray(graph.real_edge_mask())
    s = np.asarray(graph.senders)[emask]
    r = np.asarray(graph.receivers)[emask]
    keep = s != r
    jpart = JGraphPartition(s[keep], r[keep], graph.num_nodes, 2,
                            devices=jax.devices()[:2])
    model = jmodels.DistGAT(num_classes=ds.num_classes)
    params = jpart.init_model(model, jpart.shard_nodes(np.asarray(graph.x)),
                              jax.random.PRNGKey(0))
    want = jdriver.training_net_partitioned("Cora", "GAT", 2, epochs=3)
    got = driver.training_net_partitioned(
        "Cora", "GAT", 2, epochs=3, device="cpu", root=tmp_path / "port",
        state_dict=params_from_jax(params))
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("val_acc", "test_acc", "num_devices", "epochs", "model"):
        assert got[k] == pytest.approx(want[k]), k
    with pytest.raises(ValueError, match="GCN/SAGE/GAT"):
        driver.training_net_partitioned("Cora", "RGCN", 2, device="cpu")
