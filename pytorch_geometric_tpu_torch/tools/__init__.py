"""The port's measurement scripts, counterparts of the repository's
``tools/`` (those without a Pallas kernel), each run as
``python -m pytorch_geometric_tpu_torch.tools.<name>`` with a
``main(argv=None)`` that prints one JSON line a measured point and
returns the records:

- ``gat_sweep``, ``rgcn_sweep``: one packed-GAT layer on RCM-PubMed and
  the packed RGCN (and an epoch) on MUTAG-RDF;
- ``profile_epoch``: an epoch's device ops under ``torch.profiler``;
- ``probe_reddit``, ``sparse_tail_probe``, ``reddit_threshold_probe``,
  ``adv_asym_probe``: SpMM at Reddit's scale;
- ``gen_api_docs``: ``docs/API_torch.md``;
- ``run_contraction_sweep.sh``, ``run_contraction_sweep_dp.sh``: the
  research driver's contraction-coefficient grids.

Each takes ``--device`` (``cuda`` by default, ``cpu`` for a check at a
small size, where times are the host's). The TPU pack geometries of the
JAX scripts (windows, tiles, one-hot modes) have no counterpart.
"""
