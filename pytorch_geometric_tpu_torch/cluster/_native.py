"""ctypes bridge to the port's native host library, ``graphcore``.

Counterpart of ``pytorch_geometric_tpu/cluster/_native.py``. The port
keeps its own copy of the C++ source (``native/graphcore.cpp``, without
the TPU tile packing) and builds it with g++ into the package's
``_build/`` directory (which ``.gitignore`` lists), as
``kernels/_build.py`` builds the CUDA sources:

    g++ -O3 -shared -fPIC -std=c++17 graphcore.cpp -o _build/libgraphcore-<hash>.so

The hash covers the compiler, the flags and the source, so an edited
source is never served by an old library. The build writes a temporary
file and renames it into place, so processes that build at once (test
workers) never load half a library. The flags are the JAX package's
(no ``-march=native``): the results are bitwise those of its library.

There is no fallback: if the library cannot be built or loaded,
:func:`get_lib` raises. The plain numpy versions in ``cluster/__init__``
are references for the tests, never taken silently. Nothing is built at
import time.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "native" / "graphcore.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)
_i64, _u64, _f64 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_double

#: Each entry point's ctypes signature: (restype, argtypes).
SIGNATURES = {
    "graclus_cluster": (None, [_I64, _I64, _F64, _i64, _i64, _u64, _I64]),
    "voxel_grid": (None, [_F64, _i64, _i64, _I64, _F64, _F64, _F64, _I64]),
    "fps": (_i64, [_F64, _i64, _i64, _I64, _f64, _i64, _u64, _I64]),
    "radius": (_i64, [_F64, _i64, _F64, _i64, _i64, _I64, _I64, _f64, _i64,
                      _I64, _I64]),
    "knn": (_i64, [_F64, _i64, _F64, _i64, _i64, _I64, _I64, _i64, _I64,
                   _I64]),
    "coalesce": (_i64, [_I64, _I64, _F64, _i64, _i64, _i64, _I64, _I64,
                        _F64]),
    "sample_neighbors": (_i64, [_I64, _I64, _I64, _i64, _i64, _u64, _I64,
                                _I64]),
}

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """``_build/libgraphcore-<hash>.so``, the hash over the compiler, the
    flags and the source."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgraphcore-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Build the library if it has none for the current source; the
    seconds it took (0 if it was built already). Raises with the
    compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"graphcore build failed: cannot run {CXX!r} "
                           f"({exc})") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"graphcore build failed: {CXX} exited "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises if it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def as_f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def ptr_i64(a):
    return a.ctypes.data_as(_I64) if a is not None else None


def ptr_f64(a):
    return a.ctypes.data_as(_F64) if a is not None else None
