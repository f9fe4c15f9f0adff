"""What the probes share: the card's line, JSON output, the stream for
ctypes launches, warm and flushed device timings, the padding that holds
ablation variants at one occupancy, and the builds of edited copies of a
production source."""

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from pytorch_geometric_tpu_torch.profiling import device_ms

#: Timings per number: a probe reports their median and spread.
RUNS = 5


def require_card(name: str) -> bool:
    """True where there is a card; else says so on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: needs an NVIDIA GPU (CUDA is not available)",
          file=sys.stderr)
    return False


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_line(probe: str, source, smi: str) -> dict:
    """Build ``source`` if its library is not current and say so: the
    seconds and nvcc's ``-Xptxas -v`` report (each kernel's name, then its
    registers and spills; empty if the library was already built)."""
    from pytorch_geometric_tpu_torch.kernels import _build

    report = _build.build([], [source])[Path(source).stem]
    return {"probe": probe, "build_seconds": report["seconds"],
            "ptxas": [ln.strip() for ln in report["log"].splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln],
            "card": smi}


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def timings(fn, calls: int = 50, runs: int = RUNS) -> dict:
    """Device µs of one ``fn()``, ``runs`` times with the L2 warm and
    ``runs`` times flushed before each call (``profiling.device_ms``):
    the median of each and its spread (largest less smallest)."""
    out = {}
    for key, flush in (("warm", False), ("flushed", True)):
        us = [device_ms(fn, calls, flush_l2=flush) * 1e3
              for _ in range(runs)]
        out[f"{key}_us"] = statistics.median(us)
        out[f"{key}_spread_us"] = max(us) - min(us)
    return out


def floor_line(probe: str, calls: int = 50, smi: str = "") -> dict:
    """The launch floor: device µs of a plain launch of an empty kernel of
    256 threads a block at 192 and 1056 blocks (``probe_empty`` of
    ``probes/fused_gcn_designs.cu``, no cooperative launch, no barrier),
    timed as :func:`timings` times a kernel. What no lane map of a kernel
    can remove from its time."""
    from probes import fused_gcn_designs

    lib = fused_gcn_designs.load()

    def empty(blocks):
        rc = lib.probe_empty(0, 0, blocks, stream())
        if rc != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {rc}")

    return {"probe": probe, "floor_us": {
        f"plain_{blocks}_blocks": timings(lambda: empty(blocks), calls)
        for blocks in (192, 1056)}, "calls": calls, "card": smi}


def row_lengths(row_ptr) -> dict:
    """max, p99 and mean edges per row of a CSR."""
    n = (row_ptr[1:] - row_ptr[:-1]).double()
    return {"max": int(n.max()), "p99": float(torch.quantile(n, 0.99)),
            "mean": float(n.mean())}


def occupancy_padding(blocks_per_sm, modes, step: int = 1024,
                      limit: int = 227 * 1024):
    """``(smem, blocks)``: the least dynamic shared memory per block, a
    multiple of ``step``, at which no mode of ``modes`` fits more blocks
    per SM than ``full`` does without any, and that count.
    ``blocks_per_sm(mode, smem)`` asks the occupancy calculator. A variant
    that frees registers fits more blocks than full, and then gains from
    more resident warps as well as from the term it removes; launched
    with this padding (full too, so that every mode leaves the L1 the
    same share of the SM's memory) it holds full's count. A variant that
    needs more registers than full keeps its lower count."""
    target = blocks_per_sm("full", 0)
    smem = 0
    while any(blocks_per_sm(mode, smem) > target for mode in modes):
        smem += step
        if smem > limit:
            raise RuntimeError(f"no padding up to {limit} B holds {modes} "
                               f"at {target} blocks per SM")
    return smem, target


def variant_source(library, edits, head: str = "") -> str:
    """The text of the CUDA source ``library`` with ``edits`` ((text,
    replacement) pairs) made, each text found exactly once, and ``head``
    put after its first ``#include "..."`` line."""
    text = Path(library).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant anchor found {text.count(old)} "
                             f"times: {old[:60]!r}")
        text = text.replace(old, new)
    if not head:
        return text
    first = re.search(r'^#include "[^"]+"\n', text, re.M)
    return text[:first.end()] + head + text[first.end():]


def build_variants(library, variants, signatures, extra_files=None):
    """{name: (loaded library, nvcc's register lines)} of each variant of
    the CUDA source ``library`` (name -> (edits, extra signatures, head),
    as :func:`variant_source` takes them), each built through
    ``kernels/_build.py`` from its own copy under the git-ignored
    ``_build/variants/`` with the port's headers beside it (and the files
    of ``extra_files``, name -> text, such as an edited header that a
    variant includes instead), one nvcc per copy, all started together;
    ``signatures`` are the library's entry points."""
    from pytorch_geometric_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.SOURCE_DIR.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    for name, text in (extra_files or {}).items():
        (out / name).write_text(text)
    sources = {}
    for name, (edits, _, head) in variants.items():
        sources[name] = out / f"{Path(library).stem}_{name}.cu"
        sources[name].write_text(variant_source(library, edits, head))
    report = _build.build([], list(sources.values()))
    return {name: (_build.build_source(src, dict(signatures,
                                                 **variants[name][1])),
                   [ln.strip() for ln in report[src.stem]["log"].splitlines()
                    if "registers" in ln])
            for name, src in sources.items()}
