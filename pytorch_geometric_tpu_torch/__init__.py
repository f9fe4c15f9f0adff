"""PyTorch + CUDA port of pytorch_geometric_tpu, for one NVIDIA H100.

Module names and public layouts follow the JAX package, which stays the
reference. This package imports torch and numpy, never jax and nothing
of ``pytorch_geometric_tpu``. Its kernels are hand-written CUDA C++
under ``csrc/``, built with nvcc for ``sm_90a`` on first use
(``kernels/_build.py``). Entry points run on ``device="cuda"`` unless
the caller asks for the CPU, where each kernel's wrapper computes the
same function in plain PyTorch.
"""

__version__ = "0.1.0"
