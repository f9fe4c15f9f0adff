"""Aggregation ops: segment reductions, CSR build, SpMM and its kernel."""
