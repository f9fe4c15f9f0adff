"""Probes of the port's CUDA kernels, run on one NVIDIA GPU: design
alternatives (``fused_gcn_designs.py``), term-by-term ablations
(``gat_ablate.py``, ``rgcn_ablate.py``) and prefetch depths
(``rgcn_pipe_probe.py``). Each script prints JSON lines and exits
non-zero without a card."""
