"""The port's example scripts, counterparts of the reference's
``examples/gcn.py``, ``gat.py`` and ``rgcn.py`` with the same flags and
defaults, run as ``python -m pytorch_geometric_tpu_torch.examples.gcn``
(``.gat``, ``.rgcn``). On a CUDA device each trains with its epochs
captured in one CUDA graph (``models/capture.py``), the counterpart of
the JAX scripts' one ``lax.scan`` program. Importing a module runs
nothing."""
