"""What the port's tool scripts share: the ``--device`` flag, the card's
line, one JSON line a measured point, a timer that says where it ran,
and the check of an operator against its plain version before any
timing.

On the card a time is device time: ``profiling.device_ms``, ``calls``
calls captured in one CUDA graph and timed with CUDA events (keys
``*_device_us``). On the CPU (``--device cpu``, for a check at a tiny
size) it is the host's best-of wall time (keys ``*_host_us``), never
written under a device name.
"""

import json
import subprocess

import torch

from pytorch_geometric_tpu_torch.device import resolve_device
from pytorch_geometric_tpu_torch.profiling import device_ms, time_fn


def add_device(ap, calls: int = 50):
    """``--device`` (default ``cuda``) and ``--calls``, the calls a CUDA
    graph holds per timing (the JAX scripts' ``--K``)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run and times are the host's")
    ap.add_argument("--calls", type=int, default=calls)


def where(device) -> dict:
    """The run's device: on a card its name and power limit as
    ``nvidia-smi`` gives them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device": str(dev)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"device": str(dev), "card": smi}


def timed(name: str, fn, device, calls: int = 50) -> dict:
    """``{name}_device_us`` (a CUDA graph of ``calls`` calls) on a card,
    ``{name}_host_us`` (best of 3 wall times) on the CPU."""
    if torch.device(device).type == "cuda":
        return {f"{name}_device_us": device_ms(fn, calls) * 1e3}
    return {f"{name}_host_us": time_fn(fn, iters=3) * 1e6}


def per_edge(line: dict, edges: int) -> dict:
    """``line`` with each ``*_us`` time also as ``*_ns_per_edge``."""
    for key in [k for k in line if k.endswith("_us")]:
        line[key.replace("_us", "_ns_per_edge")] = line[key] * 1e3 / edges
    return line


def rel_err(got, want) -> float:
    """Largest error relative to the largest reference magnitude."""
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def check(what: str, got, want, tol: float) -> float:
    """``got`` (a tensor or a sequence of them) against ``want``; raises
    on a mismatch, else returns the error."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = rel_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{what}: error {err} against the plain "
                             f"version, above {tol}")
    return err


def emit(records: list, record: dict) -> dict:
    """Prints ``record`` as one JSON line and keeps it."""
    print(json.dumps(record), flush=True)
    records.append(record)
    return record
