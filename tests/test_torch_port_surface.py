"""The port's public surface against the JAX package's, module by module.

A module counts as ported when the port has a file at the same path as
the reference's (``__init__.py`` files excepted: they re-export modules
that are not ported yet, each with its item in ROADMAP.md). Checked for
every ported module, unless an exemption table below names the gap with
its reason:

- every public top-level name of the reference file (functions, classes,
  assignments) exists in the port;
- every public method of a class that both files define exists in the
  port's class, methods inherited from bases inside each package
  included (the reference's ``InMemoryDataset`` has ``shuffle`` from
  ``Dataset``);
- every parameter name of a function or method that both files define
  (public ones, and ``__init__`` / ``__call__`` / ``__getitem__``)
  exists in the port's. A flax module's fields stand for its
  constructor's parameters, and its ``__call__`` for a torch module's
  ``forward``.

Both packages are read with ``ast``: nothing is imported, so no JAX
either.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "pytorch_geometric_tpu"
PORT = REPO / "pytorch_geometric_tpu_torch"

_TPU_PACKING = ("TPU packing: the port's CSR (ops/csr.py:build_csr) "
                "takes its role")
_NO_CACHE = ("the port writes nothing under a dataset's root: no processed "
             "cache, no download (data/dataset.py)")

#: {module: {name: reason}} of the reference's public names (``Class.
#: method`` for methods) the port leaves out on purpose.
EXEMPT = {
    "ops/sorted_spmm.py": {"SortedPack": _TPU_PACKING,
                           "pack_sorted": _TPU_PACKING},
    "ops/spmm.py": {
        "SpmmOperator.pack_weights": _TPU_PACKING,
        "SpmmOperator.pack_weights_host": _TPU_PACKING,
        "SpmmOperator.apply_packed": _TPU_PACKING,
        "pad_bi_tables": (
            "pads TPU tile tables with no-op tiles so that shard_map "
            "devices share one shape; each rank runs its own program "
            "(parallel/fast.py holds only its rank's CSRs), so no shape is "
            "common to the ranks")},
    "data/dataset.py": {"files_exist": _NO_CACHE, "makedirs": _NO_CACHE},
    "utils/optim.py": {"CompactAdamState": (
        "optax's state tuple; the port's optimizer keeps its state as "
        "torch optimizers do, the count in param_groups[i]['count'] and "
        "the moments in state[p]['mu'] / ['nu']")},
    "research/fiedler_sgd.py": {"FiedlerSGDState": (
        "optax's state tuple; fiedler_sgd returns a torch optimizer, "
        "whose momentum is state[p]['trace']")},
}

#: {method: reason}: methods left out of every class that has them in
#: the reference (the dataset base's cache).
EXEMPT_METHODS = {"download": _NO_CACHE, "process": _NO_CACHE,
                  "processed_dir": _NO_CACHE,
                  "processed_file_names": _NO_CACHE,
                  "processed_paths": _NO_CACHE}

_TPU_KNOB = ("a TPU tiling or kernel-variant knob; the CUDA kernels take "
             "no such choice")
#: {parameter: reason}: the reference's parameter names the port leaves
#: out wherever they occur.
EXEMPT_PARAMS = {
    "window": _TPU_KNOB, "window_dst": _TPU_KNOB, "tile": _TPU_KNOB,
    "interpret": _TPU_KNOB, "onehot": _TPU_KNOB, "out_t": _TPU_KNOB,
    "light": _TPU_KNOB, "merge_dd": _TPU_KNOB, "mask_dtype": _TPU_KNOB,
    "rows": _TPU_KNOB, "f_tile": _TPU_KNOB,
    "axis": "a shard_map mesh axis; a rank hands its collectives the "
            "process group (group=)",
    "pallas": "the GCN trainer's backend= takes its place: backend="
              "\"hybrid\" is the JAX pallas=True (HybridSpmm)",
    "dense": "the GCN trainer's backend= takes its place (ROADMAP.md "
             "Queue C, gaps)",
    "dense_dtype": "the GCN trainer's backend= takes its place (ROADMAP.md "
                   "Queue C, gaps)",
}

#: {module: {function: {parameter: reason}}}: parameters left out of one
#: function only.
EXEMPT_PARAMS_AT = {
    "nn/inits.py": {
        name: {"key": "a JAX PRNG key; the port draws from a torch "
                      "generator (generator=)"}
        for name in ("glorot", "kaiming_uniform", "ones", "zeros")},
    "ops/spmm.py": {"SpmmGeom.make": {
        p: _TPU_PACKING + " (counts of source and destination windows)"
        for p in ("nsw_f", "ndw_f", "nsw_b", "ndw_b")}},
    "ops/block_spmm.py": {
        f"{cls}.__init__": {
            "sparse_tile": "the sparse remainder's TPU tile (its padding "
                           "per bucket); the remainder is a CSR "
                           "(ops/csr.py:build_csr), which has none",
            "sparse_window_src": "a wider source window of the TPU "
                                 "remainder's packed tiles; a CSR has no "
                                 "windows"}
        for cls in ("BlockStructure", "BlockSpmm")},
    **{module: {f"{cls}.__init__": {"sparse_tile": (
        "the TPU tile of the sparse remainder's packing; the remainder is a "
        "CSR (ops/csr.py:build_csr), which has none")}}
       for module, cls in (("parallel/fast.py", "PartitionedSpmm"),
                           ("parallel/api.py", "GraphPartition"))},
    "nn/conv/rgcn_conv.py": {"rgcn_fused_op": {
        "backend": "one fused operator: kernels on a CUDA graph, their "
                   "plain versions on a CPU graph (no switch to plain "
                   "segment ops on a card)",
        "kw": "the reference passes TPU knobs through it"}},
}

_CALLS = ("__init__", "__call__", "__getitem__")


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return {n for n in names if n not in ("self", "cls")}


def _tree(path: Path):
    return ast.parse(path.read_text())


def _package_imports(root: Path, tree):
    """{local name: (module path, name)} of ``from <package>.x import y``."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == root.name:
            path = "/".join(node.module.split(".")[1:]) + ".py"
            for alias in node.names:
                out[alias.asname or alias.name] = (path, alias.name)
    return out


def _class(root: Path, module: str, name: str):
    """``({method: parameter names}, [fields])`` of class ``name`` in
    ``module``, with what it inherits from its bases inside the package
    (the class's own definitions first, then each base's in order)."""
    tree = _tree(root / module)
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    imports = _package_imports(root, tree)
    methods, fields = {}, []
    for node in classes[name].body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[node.name] = _params(node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            fields.append(node.target.id)
    for base in classes[name].bases:
        if not isinstance(base, ast.Name):
            continue
        if base.id in classes and base.id != name:
            where = (module, base.id)
        elif base.id in imports and (root / imports[base.id][0]).is_file():
            where = imports[base.id]
        else:
            continue   # outside the package (nn.Module, dict, ...)
        more, more_fields = _class(root, *where)
        for k, v in more.items():
            methods.setdefault(k, v)
        fields += [f for f in more_fields if f not in fields]
    return methods, fields


def _surface(root: Path, module: str):
    """(public top-level names, {function: parameters}, {class: (methods,
    fields)}) of ``module`` under ``root``."""
    tree = _tree(root / module)
    top, functions, classes = set(), {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            top.add(node.name)
            functions[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            top.add(node.name)
            classes[node.name] = _class(root, module, node.name)
        elif isinstance(node, ast.Assign):
            top.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            top.add(node.target.id)
    return {n for n in top if not n.startswith("_")}, functions, classes


def _public(methods):
    return {m for m in methods if not m.startswith("_")}


def _ported_modules():
    return sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                  if p.name != "__init__.py"
                  and (REF / p.relative_to(PORT)).is_file())


def _missing(module: str):
    """The reference's public names (``Class.method`` for methods) of
    ``module`` that the port lacks, inherited methods included."""
    ref_top, _, ref_classes = _surface(REF, module)
    port_top, _, port_classes = _surface(PORT, module)
    missing = ref_top - port_top
    for cls in set(ref_classes) & set(port_classes):
        missing |= {f"{cls}.{m}" for m in _public(ref_classes[cls][0])
                    - _public(port_classes[cls][0])}
    return missing


def _missing_params(module: str):
    """``{function or Class.method: parameter names the port lacks}`` over
    the functions and methods both files define."""
    _, ref_fns, ref_classes = _surface(REF, module)
    _, port_fns, port_classes = _surface(PORT, module)
    pairs = [(name, ref_fns[name], port_fns[name])
             for name in set(ref_fns) & set(port_fns)
             if not name.startswith("_")]
    for cls in set(ref_classes) & set(port_classes):
        (rm, rf), (pm, pf) = ref_classes[cls], port_classes[cls]
        pm = dict(pm)
        if "forward" in pm and "__call__" not in pm:
            pm["__call__"] = pm["forward"]     # a torch module's call
        rm = dict(rm, __init__=rm.get("__init__", set(rf)))
        pm["__init__"] = pm.get("__init__", set(pf))
        pairs += [(f"{cls}.{m}", rm[m], pm[m]) for m in set(rm) & set(pm)
                  if not m.startswith("_") or m in _CALLS]
    return {name: ref - port for name, ref, port in pairs if ref - port}


def _unexempt_params(module: str):
    at = EXEMPT_PARAMS_AT.get(module, {})
    out = {}
    for name, params in _missing_params(module).items():
        left = {p for p in params if p not in EXEMPT_PARAMS
                and p not in at.get(name, {})}
        if left:
            out[name] = sorted(left)
    return out


@pytest.mark.parametrize("module", _ported_modules())
def test_ported_module_has_the_reference_surface(module):
    missing = {n for n in _missing(module) - set(EXEMPT.get(module, {}))
               if n.split(".")[-1] not in EXEMPT_METHODS or "." not in n}
    assert not missing, f"{module} lacks {sorted(missing)}"


@pytest.mark.parametrize("module", _ported_modules())
def test_ported_module_has_the_reference_parameters(module):
    missing = _unexempt_params(module)
    assert not missing, f"{module} lacks parameters {missing}"


def test_every_exemption_is_still_missing_and_has_a_reason():
    """An exemption whose name the port now has, or whose module is not
    ported, is stale."""
    ported = set(_ported_modules())
    for module, names in EXEMPT.items():
        assert module in ported, module
        stale = set(names) - _missing(module)
        assert not stale, f"{module}: {sorted(stale)} are ported now"
        assert all(reason.strip() for reason in names.values())
    missing_methods = {n.split(".")[-1] for m in ported for n in _missing(m)
                       if "." in n}
    assert set(EXEMPT_METHODS) <= missing_methods
    assert all(reason.strip() for reason in EXEMPT_METHODS.values())


def test_every_parameter_exemption_is_still_missing_and_has_a_reason():
    ported = set(_ported_modules())
    missing = {m: _missing_params(m) for m in ported}
    anywhere = set().union(*(p for by_name in missing.values()
                             for p in by_name.values()))
    stale = set(EXEMPT_PARAMS) - anywhere
    assert not stale, f"{sorted(stale)} are ported now"
    assert all(reason.strip() for reason in EXEMPT_PARAMS.values())
    for module, functions in EXEMPT_PARAMS_AT.items():
        assert module in ported, module
        for name, params in functions.items():
            stale = set(params) - missing[module].get(name, set())
            assert not stale, f"{module}:{name}: {sorted(stale)} ported now"
            assert all(reason.strip() for reason in params.values())


def test_the_names_once_missing_are_ported():
    """The names a walk of both packages found missing from modules
    counted as done (ROADMAP.md Queue C 1 of PR 11, and Queue C 2: the
    dataset base's inherited methods and parameters, and
    ``PackedFlashGat``'s ``adj_bool``)."""
    for module, names in {
            "data/graph.py": {"from_edge_index", "Graph.real_node_mask"},
            "utils/loop.py": {"remove_self_loops", "self_loop_mask",
                              "contains_self_loops"},
            "nn/inits.py": {"uniform", "ones", "kaiming_uniform"},
            "data/dataset.py": {"InMemoryDataset.index_select",
                                "InMemoryDataset.shuffle",
                                "InMemoryDataset.num_classes",
                                "InMemoryDataset.data", "Dataset",
                                "Subset", "DataView"}}.items():
        assert module in _ported_modules()
        assert not names & _missing(module), module
    # properties count as methods of the class
    _, _, classes = _surface(PORT, "data/graph.py")
    assert {"edge_index", "num_edge_features"} <= set(classes["Graph"][0])
    for module, name, params in (
            ("data/dataset.py", "InMemoryDataset.__init__", {"pre_filter"}),
            ("ops/packed_gat.py", "PackedFlashGat.__init__",
             {"adj_bool", "senders", "receivers", "num_nodes"})):
        _, _, ref = _surface(REF, module)
        cls, method = name.split(".")
        assert params <= ref[cls][0][method]       # the walk sees them
        assert not params & _missing_params(module).get(name, set())


def test_the_walk_sees_inherited_methods_and_flax_fields():
    """The reference's ``InMemoryDataset`` inherits ``index_select`` and
    ``shuffle`` from ``Dataset``; a flax module's fields are its
    constructor's parameters, compared with the port's ``__init__``."""
    _, _, ref = _surface(REF, "data/dataset.py")
    assert {"index_select", "shuffle", "num_classes",
            "num_edge_features"} <= _public(ref["InMemoryDataset"][0])
    _, _, ref = _surface(REF, "nn/conv/gat_conv.py")
    methods, fields = ref["GATConv"]
    assert "__init__" not in methods and {"heads", "concat"} <= set(fields)
    assert {"closure", "shard_ctx"} <= methods["__call__"]
    assert _missing_params("nn/conv/gat_conv.py") == {}
