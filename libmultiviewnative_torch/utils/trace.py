"""Trace lines under ``LMVN_TRACE``.

Counterpart of the first part of ``libmultiviewnative_tpu/utils/trace.py``:
the reference's compile-time ``LMVN_TRACE`` dump macro becomes a runtime
environment flag that gates one-line notices, such as the dispatch ladder's
choice of rung.  The JAX module's profiler regions are not ported yet.
"""

from __future__ import annotations

import os

TRACE_ENV = "LMVN_TRACE"


def trace_enabled() -> bool:
    """Whether ``LMVN_TRACE`` is set to anything but empty, 0 or false."""
    return os.environ.get(TRACE_ENV, "0") not in ("", "0", "false", "False")


def trace_print(*args) -> None:
    """Print one ``[lmvn-trace]`` line when :func:`trace_enabled`."""
    if trace_enabled():
        print("[lmvn-trace]", *args, flush=True)
