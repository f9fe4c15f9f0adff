"""Port parity, the research layer's weight tools: ``research/admm.py``,
``research/quantization.py``, ``research/fiedler_sgd.py`` and
``research/spectral_cluster.py`` against the JAX package, on the same
numpy inputs and weights (a ``PrunableTopK``'s, carried by
``convert.params_from_jax``, so that the flax walk meets ``weight_*``,
``kernel`` and 1-D ``weight`` leaves):

- ADMM's X / Z / U updates over three rounds (percentile and soft
  threshold), its loss, the pruning masks, the pruned weights and the
  sparsity report;
- every quantizer at every level count, in place on the model;
- ``algebraic_connectivity`` and three ``fiedler_sgd`` steps on the same
  gradients against the optax transformation, with and without
  Nesterov;
- the spectral clustering's graph, components, labels, n-cut and
  shuffle null, and ``plotting.significance_report`` on an ``.npz`` of
  the weights and on a ``.pt`` checkpoint read with ``weights_only``.

Tolerance 1e-5 relative to the largest reference magnitude (the
percentile masks and the clustering exactly)."""

import jax
import numpy as np
import optax
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data.batch import collate as j_collate
from pytorch_geometric_tpu.models import prunable as jprunable
from pytorch_geometric_tpu.research import admm as jadmm
from pytorch_geometric_tpu.research import quantization as jquant
from pytorch_geometric_tpu.research import spectral_cluster as jsc
from pytorch_geometric_tpu.research.fiedler_sgd import (
    algebraic_connectivity as j_algebraic_connectivity)
from pytorch_geometric_tpu.research.fiedler_sgd import (
    fiedler_sgd as j_fiedler_sgd)
from pytorch_geometric_tpu_torch.convert import params_from_jax
from pytorch_geometric_tpu_torch.models.prunable import choose_model
from pytorch_geometric_tpu_torch.research import admm, quantization
from pytorch_geometric_tpu_torch.research import spectral_cluster as sc
from pytorch_geometric_tpu_torch.research.fiedler_sgd import (
    algebraic_connectivity, fiedler_sgd)

F_IN, CLASSES = 10, 3
_JAX = {}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _weights():
    """The JAX TopK variables (built once) and a port model carrying
    them."""
    if "topk" not in _JAX:
        rng = np.random.default_rng(0)
        datas = []
        for _ in range(4):
            n = int(rng.integers(5, 12))
            ei = np.stack([rng.integers(0, n, 2 * n),
                           rng.integers(0, n, 2 * n)])
            datas.append(JData(x=rng.normal(size=(n, F_IN)).astype(
                np.float32), edge_index=ei, y=np.int64(0)))
        jmodel = jprunable.choose_model("TopK", (9, 6), CLASSES)
        key = jax.random.PRNGKey(0)
        _JAX["topk"] = jax.jit(jmodel.init)(
            {"params": key, "dropout": key}, j_collate(datas))
    params = _JAX["topk"]
    model = choose_model("TopK", (9, 6), CLASSES, in_channels=F_IN)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


def test_admm_matches_jax():
    params, model = _weights()
    rng = np.random.default_rng(2)
    X = jadmm.update_X(params)
    Z, U = jadmm.initialize_Z_and_U(params)
    pX = admm.update_X(model)
    pZ, pU = admm.initialize_Z_and_U(model)
    names = [n for n, _ in admm.weight_paths(model)]
    assert names == ["/".join(str(q.key) for q in p)
                     for p, _ in jadmm.weight_paths(params)]
    for step in range(3):
        noise = {n: rng.normal(size=t.shape).astype(np.float32) * 0.1
                 for n, t in pX.items()}
        pX = {n: t + torch.from_numpy(noise[n]) for n, t in pX.items()}
        X = jax.tree_util.tree_map_with_path(
            lambda p, x: None if x is None else x + noise[
                "/".join(str(q.key) for q in p)], X,
            is_leaf=lambda v: v is None)
        if step % 2:
            Z, pZ = jadmm.update_Z_l1(X, U, 0.05, 1.0), \
                admm.update_Z_l1(pX, pU, 0.05, 1.0)
        else:
            Z, pZ = jadmm.update_Z(X, U, 0.4), admm.update_Z(pX, pU, 0.4)
        U, pU = jadmm.update_U(U, X, Z), admm.update_U(pU, pX, pZ)
    for tree, port in ((Z, pZ), (U, pU)):
        leaves = {"/".join(str(q.key) for q in p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert set(leaves) == set(port)
        for n, v in port.items():
            _close(v, leaves[n], 1e-5)
    loss = admm.admm_loss(torch.tensor(1.0), model, pZ, pU, 0.5, 0.1,
                          l2=True)
    jloss = jadmm.admm_loss(1.0, params, Z, U, 0.5, 0.1, l2=True)
    _close(loss, jloss, 1e-5)
    pruned, masks = jadmm.apply_prune(params, [0.3, 0.5, 0.2, 0.6, 0.1,
                                               0.4, 0.5, 0.5, 0.2, 0.3])
    _, pmasks = admm.apply_prune(model, [0.3, 0.5, 0.2, 0.6, 0.1, 0.4, 0.5,
                                         0.5, 0.2, 0.3])
    assert set(masks) == set(pmasks)
    for n, m in pmasks.items():
        _close(m, masks[n], 0.0)
    want = params_from_jax(pruned)
    for n, p in model.state_dict().items():
        _close(p, want[n], 1e-7)
    admm.apply_masks(model, pmasks)
    assert admm.print_prune(model) == pytest.approx(
        jadmm.print_prune(pruned), abs=1e-12)


@pytest.mark.parametrize("method", ["direct", "dorefa", "admm"])
@pytest.mark.parametrize("kbits", [3, 5, 7, 9])
def test_quantization_matches_jax(method, kbits):
    params, model = _weights()
    want = params_from_jax(jax.jit(jquant.quantize_params,
                                   static_argnums=(1, 2))(params, kbits,
                                                          method))
    quantization.quantize_params(model, kbits, method)
    for n, p in model.state_dict().items():
        _close(p, want[n], 1e-5)
    w = np.random.default_rng(kbits).normal(size=(8, 5)).astype(np.float32)
    G, alpha = quantization.admm_quantization(torch.from_numpy(w), kbits)
    jG, jalpha = jax.jit(jquant.admm_quantization,
                         static_argnums=(1,))(w, kbits)
    _close(G, jG, 1e-5)
    _close(alpha, jalpha, 1e-5)
    _close(quantization.dorefa_quantize(torch.from_numpy(w), kbits),
           jquant.dorefa_quantize(w, kbits), 1e-6)
    with pytest.raises(ValueError):
        quantization.quantize(torch.from_numpy(w), 1.0, 4)


@pytest.mark.parametrize("nesterov", [False, True])
def test_fiedler_sgd_matches_optax(nesterov):
    params, model = _weights()
    w = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    lam, vec = algebraic_connectivity(torch.from_numpy(w))
    jlam, jvec = j_algebraic_connectivity(w)
    _close(lam, jlam, 1e-5)
    _close(vec.abs(), np.abs(jvec), 1e-4)
    tx = j_fiedler_sgd(0.05, fiedler_coeff=0.1, nesterov=nesterov)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = fiedler_sgd(model.parameters(), 0.05,
                           fiedler_coeff=0.1, nesterov=nesterov)
    names = dict(model.named_parameters())
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        flat = params_from_jax(grads)
        for n, p in names.items():
            p.grad = flat[n].clone()
        opt.step()
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    want = params_from_jax(params)
    for n, p in names.items():
        _close(p, want[n], 1e-5)


def test_spectral_clustering_matches_jax():
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=(8, 6)), rng.normal(size=(6, 4))]
    ws[0][:4, 3:] = 0.0
    ws[0][4:, :3] = 0.0
    adj, jadj = sc.weights_to_graph(ws), jsc.weights_to_graph(ws)
    assert (adj != jadj).nnz == 0
    w2, a2 = sc.delete_isolated_ccs(ws, adj)
    jw2, ja2 = jsc.delete_isolated_ccs(ws, jadj)
    assert all(np.array_equal(a, b) for a, b in zip(w2, jw2))
    labels = sc.cluster_net(3, a2, seed=0)
    assert np.array_equal(labels, jsc.cluster_net(3, ja2, seed=0))
    assert sc.ncut(w2, 3, labels) == jsc.ncut(jw2, 3, labels)
    res = sc.run_clustering(ws, 3, num_shuffle_samples=3, num_workers=1)
    jres = jsc.run_clustering(ws, 3, num_shuffle_samples=3, num_workers=1)
    assert res["ncut"] == jres["ncut"]
    np.testing.assert_array_equal(res["shuffle_ncuts"],
                                  jres["shuffle_ncuts"])
    assert res["pvalue"] == jres["pvalue"]


def test_significance_report_matches_jax_and_reads_a_checkpoint(tmp_path):
    from pytorch_geometric_tpu.research import plotting as jplotting
    from pytorch_geometric_tpu_torch.research import plotting
    from pytorch_geometric_tpu_torch.research.checkpoint import (
        CheckpointManager)
    from pytorch_geometric_tpu_torch.research.spectral import (
        layer_weight_items)

    _, model = _weights()
    ws = [w for _, w in layer_weight_items(model)]
    npz = tmp_path / "w.npz"
    np.savez(npz, *ws)
    kw = dict(num_clusters=2, num_samples=2, num_workers=1)
    want = jplotting.significance_report(str(npz), **kw)
    assert plotting.significance_report(str(npz), **kw) == want
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_best("net", 1.0, model.state_dict(), {})
    assert plotting.significance_report(ckpt.path("net"), **kw) == want
