"""Local fp32 pins for the library's matrix products and convolutions.

The engine's accuracy contract is fp32.  PyTorch lets a caller route fp32
matmuls and cuDNN convolutions through TF32 tensor cores (an error of the
1e-3 class), and ``torch.backends.cudnn`` does so for convolutions by
default.  These context managers pin fp32 inside and restore the caller's
settings after, so nothing global is left changed.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmuls():
    """Full fp32 matmuls inside, the caller's setting restored after: a
    caller's ``torch.backends.cuda.matmul.allow_tf32 = True`` (or
    ``set_float32_matmul_precision("high")``) would run them in TF32.  Both
    of PyTorch's settings are saved: the legacy precision string and, where
    it exists, ``torch.backends.cuda.matmul.fp32_precision``; reading the
    legacy one raises once a caller has mixed the two."""
    matmul = torch.backends.cuda.matmul
    saved_new = getattr(matmul, "fp32_precision", None)
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:
        saved = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved is not None:
            torch.set_float32_matmul_precision(saved)
        if saved_new is not None:
            matmul.fp32_precision = saved_new


def _cudnn_tf32_handles():
    """The per-operator cuDNN precision settings of this PyTorch (``conv``
    and ``rnn``), or None where only the legacy ``allow_tf32`` exists."""
    cudnn = torch.backends.cudnn
    ops = [getattr(cudnn, name, None) for name in ("conv", "rnn")]
    if all(op is not None and hasattr(op, "fp32_precision") for op in ops):
        return ops
    return None


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions in full fp32 inside, the caller's settings
    restored after.  ``torch.backends.cudnn.allow_tf32`` defaults to True.
    Where PyTorch has the per-operator settings, both ``conv`` and ``rnn``
    are set to ``"ieee"`` (setting one alone leaves a mixed state that the
    legacy flag refuses to report); else the legacy flag is cleared."""
    cudnn = torch.backends.cudnn
    ops = _cudnn_tf32_handles()
    if ops is None:
        saved = cudnn.allow_tf32
        cudnn.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32 = saved
        return
    saved = [op.fp32_precision for op in ops]
    for op in ops:
        op.fp32_precision = "ieee"
    try:
        yield
    finally:
        for op, value in zip(ops, saved):
            op.fp32_precision = value
