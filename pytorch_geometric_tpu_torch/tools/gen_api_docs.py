"""Writes the port's API reference, ``docs/API_torch.md``, from its live
public surface.

    python -m pytorch_geometric_tpu_torch.tools.gen_api_docs [--out PATH]

Counterpart of ``tools/gen_api_docs.py``: a table a package (each name
of its ``__all__``, or its public names where it has none: kind, call
signature, first docstring line), then the research layer's and the ops
layer's modules with the first line of each docstring. Every path is
anchored to this file's place in the package, not to the working
directory: it runs the same from any directory. ``--out`` defaults to
the repository's ``docs/API_torch.md``. Imports nothing of JAX and
needs no card.
"""

import argparse
import importlib
import inspect
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
REPO = PACKAGE.parent
OUT = REPO / "docs" / "API_torch.md"

#: (module, what it holds).
MODULES = [
    ("pytorch_geometric_tpu_torch.data",
     "Graph data core: host ``Data``, the device ``Graph``, batching, "
     "loaders, datasets base"),
    ("pytorch_geometric_tpu_torch.datasets",
     "Benchmark corpora (raw parsers, and deterministic synthetic graphs "
     "of the published shapes)"),
    ("pytorch_geometric_tpu_torch.transforms",
     "Data -> Data feature and geometry derivations"),
    ("pytorch_geometric_tpu_torch.nn.conv",
     "The conv zoo: GCN, GAT, RGCN and the message-passing convs"),
    ("pytorch_geometric_tpu_torch.nn.pool", "Pooling and readouts"),
    ("pytorch_geometric_tpu_torch.nn.models",
     "Graph autoencoders and deep graph infomax"),
    ("pytorch_geometric_tpu_torch.utils", "Index-space graph helpers"),
    ("pytorch_geometric_tpu_torch.cluster",
     "Host clustering and sampling over the native graphcore library"),
    ("pytorch_geometric_tpu_torch.parallel",
     "Data parallelism and edge-partitioned training on "
     "torch.distributed"),
]


def first_doc_line(src: str) -> str:
    """The first line of a module's docstring, from its source."""
    src = src.lstrip()
    if src.startswith(('"""', "'''")):
        return src[3:].split('"""')[0].split("'''")[0].strip().split(
            "\n")[0]
    return ""


def public_names(mod):
    """``mod.__all__``, or its public names where it has none."""
    return list(getattr(mod, "__all__", None)
                or [n for n in dir(mod) if not n.startswith("_")])


def table(mod) -> list:
    rows = ["| name | kind | summary |\n", "|---|---|---|\n"]
    for n in sorted(public_names(mod)):
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        doc = (inspect.getdoc(obj) or "").strip().split("\n")[0]
        kind = ("class" if inspect.isclass(obj)
                else "function" if callable(obj) else "value")
        try:
            sig = str(inspect.signature(obj)) if callable(obj) else ""
        except (ValueError, TypeError):
            sig = ""
        if len(sig) > 80:
            sig = sig[:77] + "..."
        shown = f"{n}{sig}" if kind == "function" else n
        doc = doc.replace("|", "\\|")
        rows.append(f"| `{shown}` | {kind} | {doc} |\n")
    return rows


def module_list(sub: str, prefix: str) -> list:
    return [f"- `{prefix}.{p.stem}` — {first_doc_line(p.read_text())}\n"
            for p in sorted((PACKAGE / sub).glob("*.py"))
            if p.name != "__init__.py"]


def render() -> str:
    out = ["# API reference of the PyTorch port\n\n",
           "Generated from `pytorch_geometric_tpu_torch`'s public "
           "`__all__` surfaces by "
           "`python -m pytorch_geometric_tpu_torch.tools.gen_api_docs`. "
           "The JAX package's reference is `docs/API.md`.\n"]
    for name, blurb in MODULES:
        mod = importlib.import_module(name)
        out.append(f"\n## `{name}`\n\n{blurb}.\n\n")
        out += table(mod)
    out.append("\n## `pytorch_geometric_tpu_torch.research`\n\n"
               "The research layer (pruning, spectral analysis, "
               "quantization), one module a workflow:\n\n")
    out += module_list("research", "research")
    out.append("\n## Kernel layer (`pytorch_geometric_tpu_torch.ops`)\n\n"
               "The operators under the nn layer and the wrappers of the "
               "hand-written CUDA kernels (`csrc/`):\n\n")
    out += module_list("ops", "ops")
    out.append("\n## Tools (`pytorch_geometric_tpu_torch.tools`)\n\n"
               "Measurement scripts, each run as "
               "`python -m pytorch_geometric_tpu_torch.tools.<name>`:\n\n")
    out += module_list("tools", "tools")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    text = render()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"wrote {out} ({len(text)} chars)")
    return out


if __name__ == "__main__":
    main()
