"""Port parity, slice 16: the structural transforms (``Compose``,
``ToDense``, ``Constant``, ``AddSelfLoops``, ``OneHotDegree``) and the
utilities ``to_dense_adj``, ``to_dense_batch``, ``normalized_cut``,
``k_hop_subgraph``, ``to_networkx`` and ``from_networkx`` against the
JAX package on the same inputs. Host transforms and index bookkeeping
compare exactly; the torch utilities in fp32 within 1e-5 of the largest
reference magnitude.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import Data as JData
from pytorch_geometric_tpu.data import collate as j_collate
from pytorch_geometric_tpu.transforms import AddSelfLoops as JAddSelfLoops
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import Constant as JConstant
from pytorch_geometric_tpu.transforms import OneHotDegree as JOneHotDegree
from pytorch_geometric_tpu.transforms import ToDense as JToDense
from pytorch_geometric_tpu.utils.k_hop_subgraph import (
    k_hop_subgraph as j_k_hop)
from pytorch_geometric_tpu.utils import normalized_cut as j_normalized_cut
from pytorch_geometric_tpu.utils import to_dense_adj as j_to_dense_adj
from pytorch_geometric_tpu.utils import to_dense_batch as j_to_dense_batch
from pytorch_geometric_tpu_torch.data import Data, collate
from pytorch_geometric_tpu_torch.transforms import (
    AddSelfLoops, Compose, Constant, OneHotDegree, ToDense)
from pytorch_geometric_tpu_torch.utils import (
    normalized_cut, to_dense_adj, to_dense_batch)
from pytorch_geometric_tpu_torch.utils.k_hop_subgraph import k_hop_subgraph

REPO = Path(__file__).resolve().parents[1]


def _arrays(seed=0, n=12, e=30, x=True, weight=False, pos=False):
    rng = np.random.default_rng(seed)
    out = dict(edge_index=np.stack([rng.integers(0, n, e),
                                    rng.integers(0, n, e)]),
               y=np.int64(rng.integers(0, 3)))
    out["edge_index"][:, :3] = [[1, 2, 4], [1, 2, 3]]    # self loops
    if x:
        out["x"] = rng.normal(size=(n, 3)).astype(np.float32)
    if weight:
        out["edge_attr"] = rng.random(e).astype(np.float32)
    if pos:
        out["pos"] = rng.normal(size=(n, 2)).astype(np.float32)
    if not x and not pos:
        out["num_nodes"] = n
    return out


def _same(a, b):
    for key in sorted(set(a.keys) | set(b.keys)):
        va, vb = a[key], b[key]
        assert va is not None and vb is not None, key
        np.testing.assert_array_equal(va, np.asarray(vb), err_msg=key)
        assert np.asarray(va).dtype == np.asarray(vb).dtype, key


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "to_dense", "to_dense_weighted", "to_dense_no_x", "constant",
    "constant_replace", "constant_no_x", "self_loops", "one_hot_out",
    "one_hot_in_replace", "compose"])
def test_structural_transforms_match_jax(name):
    cases = {
        "to_dense": (dict(pos=True), lambda m: m.ToDense(16)),
        "to_dense_weighted": (dict(weight=True), lambda m: m.ToDense(14)),
        "to_dense_no_x": (dict(x=False), lambda m: m.ToDense(12)),
        "constant": ({}, lambda m: m.Constant(0.5)),
        "constant_replace": ({}, lambda m: m.Constant(2.0, cat=False)),
        "constant_no_x": (dict(x=False), lambda m: m.Constant()),
        "self_loops": ({}, lambda m: m.AddSelfLoops()),
        "one_hot_out": ({}, lambda m: m.OneHotDegree(3)),
        "one_hot_in_replace": ({}, lambda m: m.OneHotDegree(
            5, in_degree=True, cat=False)),
        "compose": ({}, lambda m: m.Compose([m.AddSelfLoops(),
                                             m.OneHotDegree(4),
                                             m.Constant()])),
    }
    kw, make = cases[name]

    class Port:
        ToDense, Constant, AddSelfLoops = ToDense, Constant, AddSelfLoops
        OneHotDegree, Compose = OneHotDegree, Compose

    class Jax:
        ToDense, Constant, AddSelfLoops = JToDense, JConstant, JAddSelfLoops
        OneHotDegree, Compose = JOneHotDegree, JCompose

    arrays = _arrays(**kw)
    _same(make(Port)(Data(**arrays)), make(Jax)(JData(**arrays)))
    assert repr(make(Port)) == repr(make(Jax)) \
        or "object at" in repr(make(Jax))


def test_add_self_loops_drops_existing_loops_then_adds_one_per_node():
    d = AddSelfLoops()(Data(**_arrays()))
    s, r = d.edge_index
    loops = s == r
    np.testing.assert_array_equal(np.sort(s[loops]), np.arange(12))


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------

def _batched(seed=0):
    """Three graphs collated by both packages (padding nodes, padding
    edges, a padding graph)."""
    recs = [_arrays(seed + i, n=n, e=2 * n) for i, n in enumerate((5, 9, 7))]
    return (collate([Data(**r) for r in recs], device="cpu"),
            j_collate([JData(**r) for r in recs]))


@pytest.mark.parametrize("weighted", [False, True])
def test_to_dense_adj_single_graph_matches_jax(weighted):
    rng = np.random.default_rng(1)
    s, r = rng.integers(0, 10, 40), rng.integers(0, 10, 40)
    s[:4], r[:4] = 3, 7                                # a repeated edge
    w = rng.normal(size=40).astype(np.float32) if weighted else None
    got = to_dense_adj(torch.from_numpy(s), torch.from_numpy(r),
                       edge_weight=None if w is None else torch.from_numpy(w))
    want = j_to_dense_adj(jnp.asarray(s), jnp.asarray(r),
                          edge_weight=None if w is None else jnp.asarray(w))
    assert got.shape == (10, 10)
    _close(got, want)
    got = to_dense_adj(torch.from_numpy(s), torch.from_numpy(r),
                       num_nodes=12)
    assert got.shape == (12, 12)
    assert float(got[3, 7]) == ((s == 3) & (r == 7)).sum() >= 4


@pytest.mark.parametrize("max_nodes", [None, 10, 6])
def test_to_dense_adj_batched_matches_jax(max_nodes):
    g, jg = _batched()
    w = np.random.default_rng(2).normal(size=g.num_edges).astype(np.float32)
    got = to_dense_adj(g.senders, g.receivers, g.batch,
                       edge_weight=torch.from_numpy(w),
                       max_num_nodes=max_nodes, edge_mask=g.edge_mask,
                       num_graphs=g.num_graphs)
    want = j_to_dense_adj(jg.senders, jg.receivers, jg.batch,
                          edge_weight=jnp.asarray(w),
                          max_num_nodes=max_nodes, edge_mask=jg.edge_mask,
                          num_graphs=jg.num_graphs)
    assert got.shape == want.shape
    _close(got, want)
    # the shapes read from the indices when they are not given
    got = to_dense_adj(g.senders, g.receivers, g.batch,
                       edge_mask=g.edge_mask)
    want = j_to_dense_adj(jg.senders, jg.receivers, jg.batch,
                          edge_mask=jg.edge_mask)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("max_nodes,masked", [(9, True), (12, True),
                                               (12, False)])
def test_to_dense_batch_matches_jax(max_nodes, masked):
    g, jg = _batched(3)
    got, mask = to_dense_batch(g.x, g.batch, g.num_graphs, max_nodes,
                               g.node_mask if masked else None)
    want, want_mask = j_to_dense_batch(jg.x, jg.batch, jg.num_graphs,
                                       max_nodes,
                                       jg.node_mask if masked else None)
    if not masked:
        # unmasked, the padding graph's nodes overflow its rows: the JAX
        # scatter writes a row from several of them, in no fixed order;
        # the port writes each kept slot once. Compare the real graphs.
        got, mask = got[:-1], mask[:-1]
        want, want_mask = want[:-1], want_mask[:-1]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_normalized_cut_matches_jax(masked):
    g, jg = _batched(4)
    w = np.random.default_rng(5).random(g.num_edges).astype(np.float32)
    got = normalized_cut(g.senders, g.receivers, torch.from_numpy(w),
                         g.num_nodes, g.edge_mask if masked else None)
    want = j_normalized_cut(jg.senders, jg.receivers, jnp.asarray(w),
                            jg.num_nodes, jg.edge_mask if masked else None)
    _close(got, want)


@pytest.mark.parametrize("flow", ["source_to_target", "target_to_source"])
@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("hops,seeds", [(1, 3), (2, [0, 7]), (3, [5])])
def test_k_hop_subgraph_matches_jax(flow, relabel, hops, seeds):
    ei = _arrays(6, n=20, e=35)["edge_index"]
    got = k_hop_subgraph(seeds, hops, ei, relabel_nodes=relabel, flow=flow)
    want = j_k_hop(seeds, hops, ei, relabel_nodes=relabel, flow=flow)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="flow"):
        k_hop_subgraph(0, 1, ei, flow="sideways")


def test_networkx_round_trip_matches_jax():
    nx = pytest.importorskip("networkx")
    from pytorch_geometric_tpu.utils import from_networkx as j_from_nx
    from pytorch_geometric_tpu.utils import to_networkx as j_to_nx
    from pytorch_geometric_tpu_torch.utils import from_networkx, to_networkx

    arrays = _arrays(7)
    g, jg = _batched(8)
    for port, ref in (
            (to_networkx(Data(**arrays), node_attrs=["x"]),
             j_to_nx(JData(**arrays), node_attrs=["x"])),
            (to_networkx(g, to_undirected=True),
             j_to_nx(jg, to_undirected=True))):
        assert type(port) is type(ref)
        assert sorted(port.edges()) == sorted(ref.edges())
        assert list(port.nodes()) == list(ref.nodes())
        for i in port.nodes():
            assert port.nodes[i].keys() == ref.nodes[i].keys()
            for k in port.nodes[i]:
                np.testing.assert_array_equal(port.nodes[i][k],
                                              ref.nodes[i][k])
    for G in (nx.karate_club_graph(), nx.gnp_random_graph(9, 0.3, seed=1,
                                                          directed=True),
              nx.empty_graph(4)):
        got, want = from_networkx(G), j_from_nx(G)
        np.testing.assert_array_equal(got.edge_index, want.edge_index)
        assert got.num_nodes == want.num_nodes


_NO_NETWORKX = """
import json, sys
sys.modules["networkx"] = None        # any import of it raises
import pytorch_geometric_tpu_torch.utils as u
from pytorch_geometric_tpu_torch.data import Data
try:
    u.to_networkx(Data(edge_index=[[0], [1]], num_nodes=2))
    raised = False
except ImportError:
    raised = True
print(json.dumps({"raised": raised}))
"""


def test_utils_import_without_networkx():
    """The card's machine has no networkx: the utilities import without
    it, and only the conversions need it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_NETWORKX], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "raised": True}
