"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

The hash covers the source, every file it includes (``#include
"..."``, followed through) and the flags, so an edited source or header
is never served by an old library. The first call to
:func:`load_library` builds what is missing; :func:`build` starts one
nvcc per source, all at once. :func:`build_source` builds and loads a
source from outside ``csrc/`` (the probes' ``.cu`` files, which include
production sources) the same way. Nothing here runs at import time, so
the package imports where there is no nvcc and no card.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: ctypes signature of each library's entry point: (restype, argtypes).
#: Every pointer and the stream are c_void_p, every int c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
_U, _F = ctypes.c_uint, ctypes.c_float
SIGNATURES = {
    "spmm_csr": {
        "spmm_csr": (_I, [_P] * 5 + [_I] * 3 + [_P]),
    },
    "packed_gat": {
        "packed_gat_fwd": (_I, [_P] * 8 + [_I] * 3 + [_U, _F, _F, _P]),
        "packed_gat_bwd": (_I, [_P] * 11 + [_I] * 3
                           + [_U, _F, _F, _I, _P]),
    },
    "flash_gat": {
        "flash_gat_fwd": (_I, [_P] * 7 + [_I] * 4 + [_U, _F, _F, _P]),
        "flash_gat_bwd_row": (_I, [_P] * 10 + [_I] * 4 + [_U, _F, _F, _P]),
        "flash_gat_bwd_col": (_I, [_P] * 10 + [_I] * 4 + [_U, _F, _F, _P]),
    },
    "packed_rgcn": {
        "packed_rgcn_fwd": (_I, [_P] * 9 + [_I] * 5 + [_P]),
        "packed_rgcn_bwd": (_I, [_P] * 13 + [_I] * 5 + [_P]),
    },
    "bsr_gat": {
        "bsr_gat_fwd": (_I, [_P] * 9 + [_I] * 5 + [_U, _F, _F, _P]),
        "bsr_gat_bwd_row": (_I, [_P] * 12 + [_I] * 5 + [_U, _F, _F, _P]),
        "bsr_gat_bwd_col": (_I, [_P] * 12 + [_I] * 5 + [_U, _F, _F, _P]),
    },
    "sorted_spmm": {
        "sorted_segment_sum": (_I, [_P] * 3 + [_I] * 3 + [_P]),
    },
    "fused_gcn": {
        "fused_gcn_fwd": (_I, [_P] * 10 + [_I] * 3 + [_U, _F, _I, _P]),
        "fused_gcn_bwd": (_I, [_P] * 11 + [_I] * 3 + [_U, _F, _I, _P]),
    },
}

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _included(source: Path) -> List[Path]:
    """``source`` and every file it includes with ``#include "..."``,
    directly or through another."""
    files, todo = [], [source]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / inc.decode()).resolve())
    return files


def _library_of(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _included(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def source_files(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` that it includes
    with ``#include "..."``, directly or through another: what its library
    is built from."""
    return _included(SOURCE_DIR / f"{name}.cu")


def library_path(name: str) -> Path:
    return _library_of(SOURCE_DIR / f"{name}.cu")


def build(names: Optional[Iterable[str]] = None,
          sources: Iterable[Path] = ()) -> Dict[str, dict]:
    """Compile every named source of ``csrc/``, and every path of
    ``sources``, that has no current library, one nvcc process per
    source, all started together. Returns, per name (a path's stem), the
    seconds it took (0 if it was already built) and nvcc's report (with
    ``-Xptxas -v``: registers and shared memory of each kernel; kept
    beside the library, so a library built earlier reports it too).
    Raises with nvcc's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = {name: SOURCE_DIR / f"{name}.cu" for name in names}
    todo.update((Path(src).stem, Path(src).resolve()) for src in sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        out = _library_of(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, src in todo.items():
        log = _library_of(src).with_suffix(".log")
        report[name] = {"seconds": 0.0,
                        "log": log.read_text() if log.exists() else ""}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def _load(source: Path, signatures) -> ctypes.CDLL:
    path = _library_of(source)
    if not path.exists():
        build([], [source])
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``restype`` / ``argtypes`` declared for each entry point."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = _load(SOURCE_DIR / f"{name}.cu",
                                    SIGNATURES[name])
    return lib


def build_source(path, signatures) -> ctypes.CDLL:
    """The loaded library of the CUDA source at ``path`` (anywhere, with
    :data:`NVCC_FLAGS`), built if it has none for its current contents
    and those of the files it includes, with ``signatures`` (entry point
    -> (restype, argtypes), as in :data:`SIGNATURES`) declared. A source
    edited since it was loaded in this process is built and loaded
    anew."""
    source = Path(path).resolve()
    key = str(_library_of(source))
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = _load(source, signatures)
    return lib
