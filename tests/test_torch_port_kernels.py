"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX, so they run on a machine with an NVIDIA
GPU and the port alone:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda

Where there is no card they skip (CUDA kernels have no CPU mode); the
CPU-side behaviour of each wrapper is covered in the other
``tests/test_torch_port_*.py`` files.
"""

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.ops.csr import build_csr
from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

N = 256


@pytest.fixture
def cuda_device():
    # decided inside the fixture, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spmm_csr_kernel_matches_plain_on_card(cuda_device):
    """The CUDA kernel against its plain version, on the card: fp32 and
    bf16 x, narrow and wide F, short rows, empty rows and long rows (one
    of 700 edges, one of 5000), both CSR directions. Two launches give
    bitwise equal results (no atomics)."""
    rng = np.random.default_rng(6)
    s = rng.integers(0, N, 2000).astype(np.int32)
    r = rng.integers(0, N - 40, 2000).astype(np.int32)   # 40 empty rows
    w = rng.normal(size=2000).astype(np.float32)
    r = np.concatenate([r, np.full(700, 3, np.int32),      # long rows
                        np.full(5000, 10, np.int32)])
    s = np.concatenate([s, np.arange(5700, dtype=np.int32) % N])
    w = np.concatenate([w, rng.normal(size=5700).astype(np.float32)])
    for rows, cols in ((r, s), (s, r)):
        csr = build_csr(rows, cols, N).to(cuda_device)
        val = torch.from_numpy(w).to(cuda_device)[csr.perm]
        for f in (1, 7, 16, 33, 128, 300):
            x = torch.randn(N, f, device=cuda_device)
            for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                got = spmm_csr(csr, val, x.to(dt))
                want = spmm_csr_plain(csr, val, x.to(dt))
                torch.cuda.synchronize()
                err = (got - want).abs().max() / want.abs().max()
                assert err <= tol, (f, dt, float(err))
                assert torch.equal(got, spmm_csr(csr, val, x.to(dt)))


@pytest.mark.cuda
def test_spmm_operator_on_card_matches_cpu(cuda_device):
    """``SpmmOperator`` on the card (forward and ``dx`` through the
    kernel, ``dw`` in plain PyTorch) against the same operator on the
    CPU, for ``__call__`` and ``bind``; the kernel's launches counted."""
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    rng = np.random.default_rng(7)
    s = rng.integers(0, N, 3000)
    r = rng.integers(0, N, 3000)
    w = torch.from_numpy(rng.normal(size=3000).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        op = SpmmOperator(s, r, N, device=dev)
        wt = w.to(dev, copy=True).requires_grad_()
        xt = x.to(dev, copy=True).requires_grad_()
        before = spmm_csr.launches
        (op(wt, xt) ** 2).sum().backward()
        xb = x.to(dev, copy=True).requires_grad_()
        (op.bind(w.to(dev))(xb) ** 2).sum().backward()
        grads[str(dev)] = (wt.grad.cpu(), xt.grad.cpu(), xb.grad.cpu(),
                           spmm_csr.launches - before)
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    assert cpu[3] == 0 and card[3] == 4
    for a, b in zip(card[:3], cpu[:3]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
