"""The port's public surface against the JAX package's, module by module.

A module counts as ported when the port has a file at the same path as
the reference's (``__init__.py`` files excepted: they re-export modules
that are not ported yet, each with its item in ROADMAP.md). Every public
top-level name of a ported module's reference file (functions, classes,
assignments), and every public method of a class that both files
define, must exist in the port, unless ``EXEMPT`` names it with its
reason. Both packages are read with ``ast``: nothing is imported, so no
JAX either.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "pytorch_geometric_tpu"
PORT = REPO / "pytorch_geometric_tpu_torch"

_TPU_PACKING = ("TPU packing: the port's CSR (ops/csr.py:build_csr) "
                "takes its role")
_QUEUE_A = "not ported yet: ROADMAP.md Queue A item {}"

#: {module: {name: reason}} of the reference's public names the port
#: leaves out on purpose.
EXEMPT = {
    "ops/sorted_spmm.py": {"SortedPack": _TPU_PACKING,
                           "pack_sorted": _TPU_PACKING},
    "ops/spmm.py": {
        "SpmmOperator.pack_weights": _TPU_PACKING,
        "SpmmOperator.pack_weights_host": _TPU_PACKING,
        "SpmmOperator.apply_packed": _TPU_PACKING,
        # the static and bipartite SpMM forms
        "SpmmGeom": _QUEUE_A.format(6),
        "BiSpmmGeom": _QUEUE_A.format(6),
        "spmm_static": _QUEUE_A.format(6),
        "spmm_bi_static": _QUEUE_A.format(6),
        "pack_bipartite_tables": _QUEUE_A.format(6),
        "pad_bi_tables": _QUEUE_A.format(6)},
    "data/dataset.py": {
        "InMemoryDataset.process": "the port writes no processed cache",
        "InMemoryDataset.processed_file_names":
            "the port writes no processed cache",
        "InMemoryDataset.data": _QUEUE_A.format(4) + " (a DataView)",
        "files_exist": _QUEUE_A.format(4),
        "makedirs": _QUEUE_A.format(4),
        "Dataset": _QUEUE_A.format(4),
        "Subset": _QUEUE_A.format(4),
        "DataView": _QUEUE_A.format(4)},
    "datasets/planetoid.py": {
        "Planetoid.download": "the port tries no download",
        "CoraFull": _QUEUE_A.format(4)},
    "datasets/molecules.py": {"QM9": _QUEUE_A.format(4),
                              "MNISTSuperpixels": _QUEUE_A.format(4)},
    "datasets/synthetic.py": {
        "synthetic_graph_classification": _QUEUE_A.format(4)},
    "nn/conv/gcn_conv.py": {"gcn_closure_norm": _QUEUE_A.format(7)},
    "nn/conv/rgcn_conv.py": {"rgcn_closure_norm": _QUEUE_A.format(7)},
}


def _surface(path: Path):
    """(public top-level names, {class: public method names})."""
    tree = ast.parse(path.read_text())
    top, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            top.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not n.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            top.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            top.add(node.target.id)
    return {n for n in top if not n.startswith("_")}, classes


def _ported_modules():
    return sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                  if p.name != "__init__.py"
                  and (REF / p.relative_to(PORT)).is_file())


def _missing(module: str):
    """The reference's public names (``Class.method`` for methods) of
    ``module`` that the port lacks."""
    ref_top, ref_classes = _surface(REF / module)
    port_top, port_classes = _surface(PORT / module)
    missing = ref_top - port_top
    for cls in set(ref_classes) & set(port_classes):
        missing |= {f"{cls}.{m}"
                    for m in ref_classes[cls] - port_classes[cls]}
    return missing


@pytest.mark.parametrize("module", _ported_modules())
def test_ported_module_has_the_reference_surface(module):
    missing = _missing(module) - set(EXEMPT.get(module, {}))
    assert not missing, f"{module} lacks {sorted(missing)}"


def test_every_exemption_is_still_missing_and_has_a_reason():
    """An exemption whose name the port now has, or whose module is not
    ported, is stale."""
    ported = set(_ported_modules())
    for module, names in EXEMPT.items():
        assert module in ported, module
        stale = set(names) - _missing(module)
        assert not stale, f"{module}: {sorted(stale)} are ported now"
        assert all(reason.strip() for reason in names.values())


def test_the_names_once_missing_are_ported():
    """The names a walk of both packages found missing from modules
    counted as done (ROADMAP.md Queue C 1)."""
    for module, names in {
            "data/graph.py": {"from_edge_index", "Graph.real_node_mask"},
            "utils/loop.py": {"remove_self_loops", "self_loop_mask",
                              "contains_self_loops"},
            "nn/inits.py": {"uniform", "ones", "kaiming_uniform"}}.items():
        assert module in _ported_modules()
        assert not names & _missing(module), module
    # properties count as methods of the class
    _, classes = _surface(PORT / "data/graph.py")
    assert {"edge_index", "num_edge_features"} <= classes["Graph"]
