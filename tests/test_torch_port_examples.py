"""The port's example scripts (``pytorch_geometric_tpu_torch/examples/``)
against the reference's ``examples/gcn.py``, ``gat.py``, ``rgcn.py`` and
``citation_suite.py``:
the same flags and defaults (read from both files' syntax trees, nothing
run), the same printed lines (the JAX script's f-strings, from its tree),
the same fields returned, and the same graph, built by the JAX package's
own calls in the same process (the synthetic corpora seed from the
process's string hash, so only one process gives both the same draw).
``ppi.py``'s and ``faust.py``'s flags and line too, and their loaders'
batches against the JAX scripts' (their models are held to the JAX
scripts' in ``tests/test_torch_port_ppi.py`` and
``tests/test_torch_port_faust.py``); so are the graph-level examples'
(mutag_gin, enzymes_topk_pool, enzymes_diff_pool, qm9_nn_conv,
autoencoder, infomax: their models in
``tests/test_torch_port_graph_examples.py``), each run at a tiny size on
the CPU, where no kernel is launched; and reddit_sage.py's, whose ``SAGE``
is held here to the JAX script's on one small sampled batch and two Adam
steps (fp32 1e-5, the steps 1e-4). mygcn.py's flags are checked here;
its run and resume in ``tests/test_torch_port_mygcn.py``."""

import ast
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu.data import from_data as j_from_data
from pytorch_geometric_tpu.datasets import FAUST as JFAUST
from pytorch_geometric_tpu.datasets import Entities as JEntities
from pytorch_geometric_tpu.data import DataLoader as JDataLoader
from pytorch_geometric_tpu.datasets import PPI as JPPI
from pytorch_geometric_tpu.datasets import Planetoid as JPlanetoid
from pytorch_geometric_tpu.transforms import Cartesian as JCartesian
from pytorch_geometric_tpu.transforms import Compose as JCompose
from pytorch_geometric_tpu.transforms import FaceToEdge as JFaceToEdge
from pytorch_geometric_tpu.transforms import NormalizeFeatures as JNormalize
from pytorch_geometric_tpu.transforms import TargetIndegree as JTargetIndegree
from pytorch_geometric_tpu.utils.reorder import (
    reorder_graph as j_reorder_graph)
from pytorch_geometric_tpu_torch.data import Data, InMemoryDataset, from_data
from pytorch_geometric_tpu_torch.examples import (
    autoencoder, citation_suite, data_parallel, distributed_gcn,
    enzymes_diff_pool, enzymes_topk_pool, faust, gat, gcn, infomax,
    mnist_data_parallel, mnist_graclus, mnist_nn_conv, mnist_voxel_grid,
    mutag_gin, mygcn, pointnet2, ppi, qm9_nn_conv, reddit_sage, rgcn)
from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {"gcn": gcn, "gat": gat, "rgcn": rgcn,
            "citation_suite": citation_suite, "ppi": ppi, "faust": faust,
            "mutag_gin": mutag_gin, "enzymes_topk_pool": enzymes_topk_pool,
            "enzymes_diff_pool": enzymes_diff_pool,
            "qm9_nn_conv": qm9_nn_conv, "autoencoder": autoencoder,
            "infomax": infomax, "mnist_graclus": mnist_graclus,
            "mnist_voxel_grid": mnist_voxel_grid,
            "mnist_nn_conv": mnist_nn_conv, "pointnet2": pointnet2,
            "reddit_sage": reddit_sage, "mygcn": mygcn,
            "data_parallel": data_parallel,
            "mnist_data_parallel": mnist_data_parallel,
            "distributed_gcn": distributed_gcn}
#: Flags a port example has beyond the JAX script's: the JAX script runs
#: one controller over every device; the port's starts its ranks.
EXTRA_FLAGS = {"distributed_gcn": {"--world-size", "--device"}}


def _tree(path):
    return ast.parse(Path(path).read_text())


def _flags(path):
    """``{flag: {keyword: value}}`` of every ``add_argument`` call."""
    flags = {}
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flags[ast.literal_eval(node.args[0])] = {
                k.arg: ast.unparse(k.value) for k in node.keywords}
    return flags


def _printed_lines(path):
    """One regular expression per ``print(f"...")`` of the script's
    ``run``: its literal text, each formatted value with a format spec a
    number, each without one (a name such as the model's) a word."""
    run = next(n for n in ast.walk(_tree(path))
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    patterns = []
    for node in ast.walk(run):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            parts = [re.escape(v.value) if isinstance(v, ast.Constant)
                     else r"-?[0-9]+(\.[0-9]+)?" if v.format_spec
                     else r"[A-Za-z0-9_]+"
                     for v in node.args[0].values]
            patterns.append(re.compile("".join(parts) + "$"))
    return patterns


def _synthetic_marker(raw):
    """The JAX datasets' ``SYNTHETIC`` marker in ``raw``: with it they take
    their synthetic branch without trying a download."""
    raw.mkdir(parents=True)
    (raw / "SYNTHETIC").write_text("1")


def _jax_planetoid(root, name="Cora"):
    _synthetic_marker(root / name / "raw")
    return JPlanetoid(str(root), name, transform=JNormalize())


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _same_graph(port, ref, names):
    assert port.num_nodes == ref.num_nodes
    assert port.num_edges == ref.num_edges
    for name in names:
        a = _np(getattr(port, name))
        b = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_flags_and_defaults_match_the_jax_script(name):
    port = _flags(Path(EXAMPLES[name].__file__))
    extra = EXTRA_FLAGS.get(name, set())
    assert extra <= set(port)
    port = {k: v for k, v in port.items() if k not in extra}
    assert port == _flags(REPO / "examples" / f"{name}.py")
    assert port, name


@pytest.mark.parametrize("name", ["gat", "gcn", "rgcn"])
def test_example_run_prints_the_jax_scripts_lines(name, capsys):
    kwargs = {"epochs": 2, "device": "cpu"}
    out = EXAMPLES[name].run(**kwargs)
    lines = capsys.readouterr().out.splitlines()
    patterns = _printed_lines(REPO / "examples" / f"{name}.py")
    assert lines and patterns
    for line in lines:
        assert any(p.match(line) for p in patterns), line
    for p in patterns:
        assert any(p.match(line) for line in lines), p.pattern
    if name == "gcn":
        assert {"train_acc", "val_acc", "test_acc", "curve"} <= set(out)
        assert out["curve"]["loss"].shape == (2,)
        assert [ln.split()[1] for ln in lines[:2]] == ["000", "001"]
    elif name == "gat":
        assert sorted(out) == ["test", "train", "val"]
        assert all(0.0 <= v <= 1.0 for v in out.values())
    else:
        assert isinstance(out, float) and 0.0 <= out <= 1.0


def test_gcn_example_builds_the_jax_scripts_graph(tmp_path):
    _, port = gcn.load("Cora", root=tmp_path / "port", device="cpu")
    ds = _jax_planetoid(tmp_path / "jax")
    _same_graph(port, j_from_data(ds[0]),
                ("x", "senders", "receivers", "y", "node_mask", "edge_mask",
                 "train_mask", "val_mask", "test_mask"))


@pytest.mark.parametrize("backend", ["auto", "none"])
def test_gat_example_builds_the_jax_scripts_graph(backend, tmp_path):
    """RCM relabels the nodes for every fused backend, as examples/gat.py
    ``run`` does, and not for ``"none"``."""
    _, port = gat.load("Cora", backend, root=tmp_path / "port",
                       device="cpu")
    data = _jax_planetoid(tmp_path / "jax")[0]
    if backend != "none":
        data = j_reorder_graph(data)
    _same_graph(port, j_from_data(data),
                ("x", "senders", "receivers", "y", "node_mask", "edge_mask",
                 "train_mask", "val_mask", "test_mask"))


def test_rgcn_example_builds_the_jax_scripts_graph(tmp_path):
    _, port = rgcn.load(root=tmp_path / "port", device="cpu")
    _synthetic_marker(tmp_path / "jax" / "entities" / "mutag" / "raw")
    ref = j_from_data(JEntities(str(tmp_path / "jax"), "MUTAG")[0])
    _same_graph(port, ref, ("senders", "receivers", "y", "node_mask",
                            "edge_mask", "edge_type"))
    for k in ("train_idx", "test_idx"):
        np.testing.assert_array_equal(_np(port.extras[k]),
                                      np.asarray(ref.extras[k]), err_msg=k)


def test_gat_flash_op_auto_is_packed():
    _, graph = gat.load("Cora", "auto", device="cpu")
    op = gat_flash_op(graph, "auto")
    assert isinstance(op, PackedFlashGat) and op.n == graph.num_nodes
    with pytest.raises(ValueError, match="backend must be"):
        gat_flash_op(graph, "none")


def _model_names(path):
    """The keys of the script's ``MODELS`` dict, from its tree."""
    node = next(n for n in _tree(path).body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "MODELS"
                        for t in n.targets))
    return sorted(ast.literal_eval(k) for k in node.value.keys)


def test_citation_suite_models_are_the_jax_scripts():
    names = _model_names(Path(citation_suite.__file__))
    assert names == _model_names(REPO / "examples" / "citation_suite.py")
    assert names == sorted(citation_suite.MODELS) == \
        ["agnn", "arma", "dna", "sgc", "spline"]
    assert _flags(Path(citation_suite.__file__))["model"] == {
        "choices": "sorted(MODELS)"}


@pytest.mark.parametrize("model", ["agnn", "arma", "dna", "sgc", "spline"])
def test_citation_suite_run_prints_the_jax_scripts_line(model, capsys):
    out = citation_suite.run(model, epochs=2, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    (pattern,) = _printed_lines(REPO / "examples" / "citation_suite.py")
    assert len(lines) == 1 and pattern.match(lines[0]), lines
    assert lines[0].startswith(f"[{model}/Cora] loss ")
    assert sorted(out) == ["test", "train", "val"]
    assert all(0.0 <= v <= 1.0 for v in out.values())


@pytest.mark.parametrize("model", ["sgc", "spline"])
def test_citation_suite_builds_the_jax_scripts_graph(model, tmp_path):
    """Spline's graph carries ``TargetIndegree``'s pseudo-coordinates,
    equal in both packages; the others carry no edge attributes."""
    _, port = citation_suite.load(model, "Cora", root=tmp_path / "port",
                                  device="cpu")
    data = _jax_planetoid(tmp_path / "jax")[0]
    if model == "spline":
        data = JTargetIndegree()(data)
    names = ["x", "senders", "receivers", "y", "node_mask", "edge_mask",
             "train_mask", "val_mask", "test_mask"]
    if model == "spline":
        names.append("edge_attr")
    else:
        assert port.edge_attr is None
    _same_graph(port, j_from_data(data), names)


class _PPILike(InMemoryDataset):
    """A few PPI-shaped graphs of ~40 nodes (50 features, 121 labels)."""

    def __init__(self, count, seed):
        self.count, self.seed = count, seed
        super().__init__(None)

    def process_full(self):
        rng = np.random.default_rng(self.seed)
        out = []
        for _ in range(self.count):
            n = int(rng.integers(30, 50))
            ei = np.stack([rng.integers(0, n, 4 * n),
                           rng.integers(0, n, 4 * n)])
            out.append(Data(x=rng.normal(size=(n, 50)).astype(np.float32),
                            edge_index=np.concatenate([ei, ei[::-1]], 1),
                            y=(rng.random((n, 121)) < 0.4).astype(
                                np.float32)))
        return out


def test_ppi_example_run_prints_the_jax_scripts_line(capsys):
    from pytorch_geometric_tpu_torch.data import DataLoader

    train = DataLoader(_PPILike(3, 0), batch_size=1, shuffle=True,
                       device="cpu")
    val = DataLoader(_PPILike(2, 1), batch_size=2, device="cpu")
    out = ppi.run(2, loaders=(train, val), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    (pattern,) = _printed_lines(REPO / "examples" / "ppi.py")
    assert len(lines) == 2 and all(pattern.match(ln) for ln in lines)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 01", "Epoch 02"]
    assert len(out["epoch_losses"]) == 2 and 0.0 <= out["f1"] <= 1.0


def test_ppi_example_loads_the_jax_scripts_batches(tmp_path):
    """The port's loaders over its PPI give the JAX script's batches, in
    its order, one epoch after the one the scripts draw to shape the
    model: the same graphs, padded to the same budgets."""
    train, val = ppi.load(seed=0, root=tmp_path / "port", device="cpu")
    jtrain = JDataLoader(JPPI(str(tmp_path / "jax"), "train"), batch_size=1,
                         shuffle=True, seed=0)
    jval = JDataLoader(JPPI(str(tmp_path / "jax"), "val"), batch_size=2)
    assert (train.num_nodes, train.num_edges, val.num_nodes,
            val.num_edges) == (jtrain.num_nodes, jtrain.num_edges,
                               jval.num_nodes, jval.num_edges) \
        == (3072, 98304, 6144, 196608)
    next(iter(train))
    next(iter(jtrain))
    got = list(itertools.islice(train, 2)) + list(val)
    want = list(itertools.islice(jtrain, 2)) + list(jval)
    for port, ref in zip(got, want, strict=True):
        _same_graph(port, ref, ("x", "senders", "receivers", "y",
                                "node_mask", "edge_mask", "batch"))


def test_faust_example_run_prints_the_jax_scripts_line(capsys):
    train, test = faust.load(seed=0, num_vertices=50, device="cpu")
    train.dataset, test.dataset = train.dataset[:3], test.dataset[:2]
    out = faust.run(2, loaders=(train, test), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    (pattern,) = _printed_lines(REPO / "examples" / "faust.py")
    assert len(lines) == 2 and all(pattern.match(ln) for ln in lines)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 01", "Epoch 02"]
    assert len(out["epoch_losses"]) == 2 and 0.0 <= out["acc"] <= 1.0


def test_faust_example_loads_the_jax_scripts_batches(tmp_path):
    """The port's loaders over its FAUST give the JAX script's batches,
    in its order, one epoch after the one the scripts draw to shape the
    model: the same meshes, padded to the same budgets, with the same
    Cartesian pseudo-coordinates."""
    train, test = faust.load(seed=0, num_vertices=50,
                             root=tmp_path / "port", device="cpu")
    pre = JCompose([JFaceToEdge(), JCartesian()])
    jtrain = JDataLoader(JFAUST(str(tmp_path / "jax"), train=True,
                                pre_transform=pre, num_vertices=50),
                         batch_size=1, shuffle=True, seed=0)
    jtest = JDataLoader(JFAUST(str(tmp_path / "jax"), train=False,
                               pre_transform=pre, num_vertices=50),
                        batch_size=1)
    assert (len(train), len(test)) == (80, 20)
    assert (train.num_nodes, train.num_edges) == (jtrain.num_nodes,
                                                  jtrain.num_edges)
    next(iter(train))
    next(iter(jtrain))
    got = list(itertools.islice(train, 3)) + list(itertools.islice(test, 2))
    want = list(itertools.islice(jtrain, 3)) + list(itertools.islice(jtest,
                                                                      2))
    for port, ref in zip(got, want, strict=True):
        _same_graph(port, ref, ("senders", "receivers", "edge_attr", "y",
                                "node_mask", "edge_mask"))


# ---------------------------------------------------------------------------
# the graph-level examples
# ---------------------------------------------------------------------------

def _assert_lines(capsys, name, count):
    """Every printed line matches one of the JAX script's, and each of
    its patterns is printed; ``count`` lines in all."""
    lines = capsys.readouterr().out.splitlines()
    patterns = _printed_lines(REPO / "examples" / f"{name}.py")
    assert len(lines) == count, lines
    for line in lines:
        assert any(p.match(line) for p in patterns), line
    for p in patterns:
        assert any(p.match(line) for line in lines), p.pattern
    return lines


def _small_loaders(loaders, train=12, test=4):
    for loader, count in zip(loaders, (train, test)):
        loader.dataset = loader.dataset[:count]
    return loaders


@pytest.mark.parametrize("name", ["mutag_gin", "enzymes_topk_pool"])
def test_graph_classification_run_prints_the_jax_scripts_line(name,
                                                              capsys):
    module = EXAMPLES[name]
    loaders = _small_loaders(module.load(batch_size=4, device="cpu"))
    out = module.run(2, loaders=loaders, device="cpu")
    lines = _assert_lines(capsys, name, 2)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 001", "Epoch 002"]
    assert len(out["epoch_losses"]) == 2 and 0.0 <= out["acc"] <= 1.0
    # the shuffled train batches are new each epoch: 3 a epoch, and the
    # test batch's once
    assert out["operators"] == 2 * 3 + 1


def test_mutag_gin_loads_the_jax_scripts_batches(tmp_path):
    """The port's loaders over its MUTAG give the JAX script's batches, in
    its order, after the epoch the scripts draw to shape the model."""
    from pytorch_geometric_tpu.datasets import TUDataset as JTUDataset

    train, test = mutag_gin.load(root=tmp_path / "port", device="cpu")
    _synthetic_marker(tmp_path / "jax" / "MUTAG" / "raw")
    ds = JTUDataset(str(tmp_path / "jax"), "MUTAG").shuffle(seed=0)
    jtrain = JDataLoader(ds[len(ds) // 10:], batch_size=32, shuffle=True,
                         seed=0)
    jtest = JDataLoader(ds[:len(ds) // 10], batch_size=32)
    assert (len(train), len(test)) == (6, 1)
    assert (train.num_nodes, train.num_edges) == (jtrain.num_nodes,
                                                  jtrain.num_edges)
    next(iter(train))
    next(iter(jtrain))
    for port, ref in zip(list(train) + list(test), list(jtrain) + list(jtest),
                         strict=True):
        _same_graph(port, ref, ("x", "senders", "receivers", "y",
                                "node_mask", "edge_mask", "batch",
                                "graph_mask"))


def test_enzymes_diff_pool_run_prints_the_jax_scripts_line(capsys):
    loaders = _small_loaders(enzymes_diff_pool.load(batch_size=4,
                                                    device="cpu"), 8, 4)
    out = enzymes_diff_pool.run(2, loaders=loaders, device="cpu")
    lines = _assert_lines(capsys, "enzymes_diff_pool", 2)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 01", "Epoch 02"]
    assert np.isfinite(out["step_losses"]).all()


def test_qm9_nn_conv_run_prints_the_jax_scripts_line(capsys):
    train, test, mean, std = qm9_nn_conv.load(batch_size=4, num_samples=10,
                                              device="cpu")
    out = qm9_nn_conv.run(2, loaders=(train, test, mean, std),
                          device="cpu")
    lines = _assert_lines(capsys, "qm9_nn_conv", 2)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 01", "Epoch 02"]
    assert out["mae"] >= 0.0 and out["operators"] == 2 * 2 + 1


def _small_graph_data(seed=0, n=60, f=12, e=150):
    """A small undirected graph with features, 3 classes and a 30 / 30
    train / test split."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = ei[:, ei[0] != ei[1]]
    ei = np.unique(np.concatenate([ei, ei[::-1]], 1), axis=1)
    return Data(x=rng.random((n, f)).astype(np.float32), edge_index=ei,
                y=rng.integers(0, 3, n), train_mask=np.arange(n) < 30,
                test_mask=np.arange(n) >= 30)


@pytest.mark.parametrize("variational", [False, True])
def test_autoencoder_run_prints_the_jax_scripts_line(variational, capsys):
    from pytorch_geometric_tpu_torch.nn.models import split_edges

    data = split_edges(_small_graph_data(), seed=0)
    out = autoencoder.run(variational, 20, device="cpu",
                          loaded=(data, from_data(data, device="cpu")))
    _assert_lines(capsys, "autoencoder", 1)
    assert 0.0 <= out["auc"] <= 1.0 and 0.0 <= out["ap"] <= 1.0
    assert out["losses"].shape == (20,)


def test_infomax_run_prints_the_jax_scripts_lines(capsys):
    graph = from_data(_small_graph_data(1), device="cpu")
    out = infomax.run(10, hidden=16, device="cpu", graph=graph)
    lines = _assert_lines(capsys, "infomax", 2)
    assert lines[0].startswith("Epoch 010")
    assert 0.0 <= out["acc"] <= 1.0


def test_autoencoder_and_infomax_load_the_jax_scripts_graphs(tmp_path):
    """The split edges and the graph of examples/autoencoder.py, and
    examples/infomax.py's Cora, as the JAX package builds them."""
    from pytorch_geometric_tpu.datasets import Planetoid as JPlanetoid
    from pytorch_geometric_tpu.nn.models import split_edges as j_split

    data, port = autoencoder.load(root=tmp_path / "port", device="cpu")
    jdata = j_split(_jax_planetoid(tmp_path / "jax")[0].clone(), seed=0)
    for key in ("train_pos_edge_index", "test_pos_edge_index",
                "test_neg_edge_index", "val_pos_edge_index",
                "val_neg_edge_index"):
        np.testing.assert_array_equal(getattr(data, key),
                                      np.asarray(getattr(jdata, key)))
    _same_graph(port, j_from_data(jdata), ("x", "senders", "receivers",
                                           "node_mask", "edge_mask"))
    ref = j_from_data(JPlanetoid(str(tmp_path / "jax"), "Cora")[0])
    _same_graph(infomax.load(root=tmp_path / "port", device="cpu"), ref,
                ("x", "senders", "receivers", "y", "node_mask", "train_mask",
                 "test_mask"))


@pytest.mark.parametrize("name", ["mnist_graclus", "mnist_voxel_grid",
                                  "mnist_nn_conv", "pointnet2"])
def test_point_and_superpixel_run_prints_the_jax_scripts_line(
        name, capsys, tmp_path):
    """Two epochs of each script at a tiny size (12 superpixel graphs in
    batches of 4; ModelNet10 at 2 samples a class in batches of 8): the
    JAX line per epoch, finite losses, and for the MNIST scripts one
    operator set a train batch an epoch and the test batch's once."""
    module = EXAMPLES[name]
    if name == "pointnet2":
        loaders = module.load(0, 8, 2, tmp_path, device="cpu")
    elif name == "mnist_graclus":
        loaders = module.load(0, 4, 12, tmp_path, device="cpu")
    else:
        loaders = mnist_voxel_grid.load(0, 4, 12, tmp_path, device="cpu")
    out = module.run(2, loaders=loaders, device="cpu")
    lines = _assert_lines(capsys, name, 2)
    assert [ln.split(",")[0] for ln in lines] == ["Epoch 01", "Epoch 02"]
    assert np.isfinite(out["step_losses"]).all()
    assert 0.0 <= out["acc"] <= 1.0
    if name != "pointnet2":
        assert (len(loaders[0]), len(loaders[1])) == (3, 1)
        assert out["operators"] == 2 * 3 + 1


# ---------------------------------------------------------------------------
# reddit_sage.py
# ---------------------------------------------------------------------------

def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _sampled_corpus(seed=0, n=400, e=3200, f=24, c=5):
    """A Reddit-shaped corpus in miniature: features, labels, and the
    train / val split masks."""
    rng = np.random.default_rng(seed)
    split = rng.random(n)
    return Data(x=rng.normal(size=(n, f)).astype(np.float32),
                edge_index=np.stack([rng.integers(0, n, e),
                                     rng.integers(0, n, e)]),
                y=rng.integers(0, c, n), train_mask=split < 0.66,
                val_mask=(split >= 0.66) & (split < 0.76))


def test_reddit_sage_run_prints_the_jax_scripts_line(capsys):
    out = reddit_sage.run(1, batch_size=16, seed=0, max_batches=2,
                          device="cpu", data=_sampled_corpus())
    lines = _assert_lines(capsys, "reddit_sage", 1)
    assert lines[0].startswith("Epoch 01")
    assert out["step_losses"].shape == (1, 2)
    assert np.isfinite(out["step_losses"]).all()
    assert 0.0 <= out["acc"] <= 1.0 and out["chance"] == 0.2


def test_reddit_sage_model_matches_the_jax_script():
    """examples/reddit_sage.py's ``SAGE`` and step against the port's on
    the same sampled batches (batch size 16, the loaders seeded alike,
    after the first batch each script draws to shape its model): the
    logits and loss of the first batch, then two Adam (3e-3) steps."""
    import sys

    import jax
    import jax.numpy as jnp
    import optax

    sys.path.insert(0, str(REPO))
    from examples.reddit_sage import SAGE as JSAGE
    from pytorch_geometric_tpu.data.neighbor_loader import (
        NeighborSampler as JNeighborSampler)
    from pytorch_geometric_tpu_torch.convert import params_from_jax

    data = _sampled_corpus(1)
    ei = data.edge_index
    train, _, x_dev, y_dev = reddit_sage.loaders(data, batch_size=16,
                                                 device="cpu")
    jtrain = JNeighborSampler(ei[0], ei[1], data.num_nodes, sizes=[10, 10],
                              batch_size=16,
                              seed_nodes=np.flatnonzero(data.train_mask),
                              seed=0, materialize_features=False)
    jx, jy = jtrain.device_tables(data.x, data.y.astype(np.int32))
    g0 = next(iter(jtrain))
    next(iter(train))
    jmodel = JSAGE(hidden=128, num_classes=5)
    params = jmodel.init(jax.random.PRNGKey(0), g0,
                         jnp.take(jx, g0.extras["local_to_global"], axis=0))
    model = reddit_sage.SAGE(24, 128, 5)
    model.load_state_dict(params_from_jax(params))
    tx = optax.adam(3e-3)
    opt = tx.init(params)
    topt = torch.optim.Adam(model.parameters(), lr=3e-3)

    @jax.jit
    def jloss(p, graph):
        ids = graph.extras["local_to_global"]
        logits = jmodel.apply(p, graph, jnp.take(jx, ids, axis=0))
        logp = jax.nn.log_softmax(logits)
        oh = jnp.take(jy, ids)[:, None] == jnp.arange(5)[None, :]
        nll = -jnp.sum(logp * oh.astype(logp.dtype), axis=1)
        m = graph.extras["seed_mask"].astype(jnp.float32)
        return jnp.sum(nll * m) / jnp.maximum(m.sum(), 1.0), logits

    grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    batches = list(itertools.islice(zip(train, jtrain), 2))
    graph, jgraph = batches[0]
    (jl, jlogits), _ = grad(params, jgraph)
    agg = reddit_sage.sage_aggregate(graph)
    ids = graph.extras["local_to_global"].long()
    with torch.no_grad():
        logits = model(graph, x_dev[ids], agg)
    _close(logits, jlogits, 1e-5)
    _close(reddit_sage.seed_loss(logits, y_dev[ids],
                                 graph.extras["seed_mask"]), jl, 1e-5)
    # the aggregation over ones, SAGEConv's degree, is the masked
    # in-degree of the JAX conv
    np.testing.assert_array_equal(
        agg(torch.ones(graph.num_nodes, 1))[:, 0].detach().numpy(),
        np.bincount(np.asarray(jgraph.receivers)[np.asarray(
            jgraph.edge_mask)], minlength=graph.num_nodes))
    for graph, jgraph in batches:
        (jl, _), grads = grad(params, jgraph)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        loss = reddit_sage.train_step(model, topt, graph, x_dev, y_dev)
        _close(loss, jl, 1e-5)
    want = params_from_jax(params)
    for name, p in model.state_dict().items():
        _close(p, want[name], 1e-4)


@pytest.mark.parametrize("name", ["data_parallel", "mnist_data_parallel",
                                  "distributed_gcn"])
def test_parallel_example_run_prints_the_jax_scripts_lines(name, capsys):
    """The DP and edge-partition examples on one gloo rank (the calling
    process): the JAX script's lines, finite results."""
    kwargs = {"data_parallel": dict(epochs=1),
              "mnist_data_parallel": dict(epochs=1, num_samples=64),
              "distributed_gcn": dict(epochs=2)}[name]
    out = EXAMPLES[name].run(world_size=1, device="cpu", **kwargs)
    lines = capsys.readouterr().out.splitlines()
    patterns = _printed_lines(REPO / "examples" / f"{name}.py")
    assert lines and patterns
    for line in lines:
        assert any(p.match(line) for p in patterns), line
    for p in patterns:
        assert any(p.match(line) for line in lines), p.pattern
    if name == "mnist_data_parallel":
        assert np.isfinite(out)
    elif name == "data_parallel":
        assert np.isfinite(out["step_losses"]).all()
    else:
        assert 0.0 <= out["test"] <= 1.0
