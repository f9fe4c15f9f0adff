"""The PyTorch port stands alone and never hides the device: importing
every module of it loads no JAX and nothing of the JAX package; entry
points default to CUDA and raise where there is none; the kernel wrapper
computes on the CPU without counting a launch and refuses other devices;
``chip_smoke.py`` fails, and prints no result, without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.data import Data, from_data
from pytorch_geometric_tpu_torch.kernels import _build
from pytorch_geometric_tpu_torch.models.citation import train_gcn
from pytorch_geometric_tpu_torch.ops.csr import build_csr
from pytorch_geometric_tpu_torch.ops.spmm import (
    SpmmOperator, spmm_csr, spmm_csr_plain)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import pytorch_geometric_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "pytorch_geometric_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _tiny_graph():
    rng = np.random.default_rng(0)
    n = 12
    mask = np.ones(n, bool)
    return Data(x=rng.random((n, 3)).astype(np.float32),
                edge_index=np.stack([rng.integers(0, n, 30),
                                     rng.integers(0, n, 30)]),
                y=rng.integers(0, 2, n), train_mask=mask, val_mask=mask,
                test_mask=mask)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pytorch_geometric_tpu_torch.models.citation" in report["modules"]
    assert "pytorch_geometric_tpu_torch.kernels._build" in report["modules"]
    assert report["bad"] == []


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _tiny_graph()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_data(data)
    graph = from_data(data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gcn(graph, num_classes=2, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpmmOperator(graph.senders, graph.receivers, graph.num_nodes)


def test_cpu_wrapper_computes_plain_and_counts_no_launch():
    spmm_csr.launches = 0
    rng = np.random.default_rng(1)
    s, r = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    csr = build_csr(r, s, 40)
    val = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    out = spmm_csr(csr, val, x)
    assert torch.equal(out, spmm_csr_plain(csr, val, x))
    graph = from_data(_tiny_graph(), device="cpu")
    train_gcn(graph, num_classes=2, epochs=3, device="cpu")
    assert spmm_csr.launches == 0


def test_wrapper_refuses_other_devices_and_bad_inputs():
    csr = build_csr(np.array([0, 1]), np.array([1, 0]), 2)
    val = torch.ones(2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_csr(csr.to("meta"), val.to("meta"),
                 torch.ones(2, 4, device="meta"))
    with pytest.raises(TypeError):
        spmm_csr(csr, val, torch.ones(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        spmm_csr(csr, val, torch.ones(3, 4))
    with pytest.raises(ValueError):
        spmm_csr(csr, torch.ones(3), torch.ones(2, 4))


def test_kernel_build_is_described_not_run_at_import():
    assert (_build.SOURCE_DIR / "spmm_csr.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("spmm_csr")
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "/pytorch_geometric_tpu_torch/_build/" in ignored


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
