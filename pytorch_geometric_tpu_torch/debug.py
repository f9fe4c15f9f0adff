"""Global debug flag.

Counterpart of ``pytorch_geometric_tpu/debug.py``: the reference's
``torch_geometric.is_debug_enabled()`` global that gates shape and range
validation inside ops (reference: gmm_conv.py:106-129). The port's
gather-aggregate ``ops/spmm.py:spmm``, the counterpart of the JAX
package's ``message_passing``, consults it and validates its edge indices
on the host before it gathers. (The CSR operators validate theirs always,
once, when they are built: ``ops/csr.py:build_csr``.)
"""

import contextlib

__debug_flag__ = {"enabled": False}


def is_debug_enabled() -> bool:
    """Return whether debug-mode input validation is enabled."""
    return __debug_flag__["enabled"]


def set_debug(enabled: bool) -> None:
    __debug_flag__["enabled"] = bool(enabled)


@contextlib.contextmanager
def debug():
    """Context manager enabling debug-mode validation within its scope."""
    prev = is_debug_enabled()
    set_debug(True)
    try:
        yield
    finally:
        set_debug(prev)
