"""Tracing and profiling hooks.

Counterpart of ``libmultiviewnative_tpu/utils/trace.py``.  The reference's
compile-time ``LMVN_TRACE`` dump macro becomes a runtime environment flag
that gates one-line notices, such as the dispatch ladder's choice of rung;
its ``cudaProfilerStart/Stop`` brackets become :func:`profile_region`, a
``torch.profiler`` trace (CUDA activity on the card) exported for
TensorBoard; :func:`span` and :func:`spanned` mark the program's layers
(``lmvn.*``) inside any such trace; and :func:`debug_context` is the NaN
sanitizer the reference lacks, raising at the op that first produces a NaN
as ``jax_debug_nans`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import time
from typing import Iterator, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast
from torch.overrides import TorchFunctionMode

TRACE_ENV = "LMVN_TRACE"
PROFILE_ENV = "LMVN_PROFILE_DIR"

# on inside debug_context(nan_checks=True), in this thread or task only
_NAN_CHECKS = contextvars.ContextVar("lmvn_nan_checks", default=False)


def trace_enabled() -> bool:
    """Whether ``LMVN_TRACE`` is set to anything but empty, 0 or false."""
    return os.environ.get(TRACE_ENV, "0") not in ("", "0", "false", "False")


def trace_print(*args) -> None:
    """Print one ``[lmvn-trace]`` line when :func:`trace_enabled`."""
    if trace_enabled():
        print("[lmvn-trace]", *args, flush=True)


def _cuda_live() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def profile_region(name: str, logdir: Optional[str] = None) -> Iterator[None]:
    """Profile a region: a ``torch.profiler`` trace into ``logdir`` (or
    ``LMVN_PROFILE_DIR``), with the card's activity when there is one;
    otherwise a wall-clock bracket printed under ``LMVN_TRACE``, which
    synchronises the card before each clock read only while tracing is on."""
    logdir = logdir or os.environ.get(PROFILE_ENV)
    if logdir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        handler = torch.profiler.tensorboard_trace_handler(logdir)
        with torch.profiler.profile(activities=activities, on_trace_ready=handler):
            with torch.profiler.record_function(name):
                yield
        return
    tracing = trace_enabled()
    if tracing and _cuda_live():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if tracing:
        if _cuda_live():
            torch.cuda.synchronize()
        trace_print(f"{name}: {1e3 * (time.perf_counter() - t0):.3f} ms")


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (``lmvn.*``), recorded exactly while a
    ``torch.profiler`` session records on this thread: the benchmark's
    traced run, :func:`profile_region` under ``LMVN_PROFILE_DIR``, or a
    caller's own profiler.  It is a host event of that trace, on the clock
    of the device activity, and adds no event to the device's timeline (a
    function-scope record, where ``record_function``'s user scope gets a
    ``gpu_user_annotation`` twin there).  With no profiler it is one check
    and a shared null context."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_SPAN


def spanned(name: str):
    """Decorate a function so that each call runs inside :func:`span`
    ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def _raise_on_nan(what: str, out) -> None:
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if (
            isinstance(t, torch.Tensor)
            and (t.is_floating_point() or t.is_complex())
            and bool(torch.isnan(t).any())
        ):
            raise FloatingPointError(f"NaN produced by {what}")


class _NanCheckMode(TorchFunctionMode):
    """Scans the floating-point results of every torch op run under it.

    Skipped: ``empty*`` factories (their memory is uninitialised) and fresh
    views (slices of a buffer hold whatever it holds; a NaN written into it
    was scanned where it was made).  An in-place op returns its operand,
    which is scanned whether or not it is a view."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if not _NAN_CHECKS.get() or name.startswith(("empty", "new_empty")):
            return out
        fresh_view = (
            isinstance(out, torch.Tensor)
            and out._base is not None
            and not any(out is a for a in args)
        )
        if not fresh_view:
            _raise_on_nan(name, out)
        return out


def check_kernel_output(name: str, *outputs: torch.Tensor) -> None:
    """Under :func:`debug_context` with NaN checks, raise
    ``FloatingPointError`` when a hand kernel's output holds a NaN: a ctypes
    launch is no torch op, so the mode cannot see it.  Each kernel wrapper
    calls this after its launch; otherwise it does nothing."""
    if _NAN_CHECKS.get():
        _raise_on_nan(f"kernel {name}", outputs)


@contextlib.contextmanager
def debug_context(nan_checks: bool = True, disable_jit: bool = False) -> Iterator[None]:
    """Numerical-debugging scope, the sanitizer tier the reference lacks.

    With ``nan_checks``, every torch op's floating-point result and every
    hand kernel's output is scanned (one host read each), and the first NaN
    raises ``FloatingPointError`` at the op or kernel that produced it.
    ``disable_jit`` is accepted for the JAX signature and does nothing:
    PyTorch runs eagerly.  Everything is restored on exit."""
    del disable_jit
    token = _NAN_CHECKS.set(bool(nan_checks))
    try:
        with _NanCheckMode() if nan_checks else contextlib.nullcontext():
            yield
    finally:
        _NAN_CHECKS.reset(token)
