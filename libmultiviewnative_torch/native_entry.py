"""Python side of the port's C ABI bridge (``native/bridge.cpp``).

Counterpart of ``libmultiviewnative_tpu/native_entry.py``.  Receives raw
buffer ADDRESSES from the C shim, wraps them as numpy arrays without copying
(ctypes), runs the flat API (:mod:`.api`) on the device the bridge names,
and copies each result from that device straight into the caller's memory:
the reference C ABI's in-place contract (``inc/multiviewnative.h:43-55``)
across the native boundary.

The bridge names ``"cpu"`` for the cpu-named symbols and ``"cuda:<n>"`` for
the GPU-named ones.  A CUDA device that this process does not have raises
before any buffer is touched (the bridge records the error); nothing runs on
the CPU instead.

Not a public API: signatures here are the bridge's wire format.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import api

_FLOATP = ctypes.POINTER(ctypes.c_float)


def _device(name: str) -> torch.device:
    """The device the bridge names, checked to exist on this host."""
    dev = torch.device(name)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if dev.index is None or not 0 <= dev.index < n:
            raise RuntimeError(f"no CUDA device {name!r}: this host has {n}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _wrap(addr: int, dims: Sequence[int]) -> np.ndarray:
    """Wrap a raw float32 buffer address as a (z, y, x) numpy view (no copy;
    writes go to the caller's memory)."""
    shape = tuple(int(d) for d in dims)
    return np.ctypeslib.as_array(ctypes.cast(int(addr), _FLOATP), shape=shape)


def _wrap_flat(addr: int, size: int) -> np.ndarray:
    return np.ctypeslib.as_array(ctypes.cast(int(addr), _FLOATP), shape=(int(size),))


def _write(dst: np.ndarray, result: torch.Tensor) -> None:
    """Copy a result from where it was computed straight into the caller's
    buffer (no host temporary)."""
    torch.from_numpy(dst).copy_(result.reshape(dst.shape))


def inplace_deconvolve(
    psi_addr: int,
    psi_dims: Tuple[int, int, int],
    views: List[tuple],
    lambda_: float,
    min_value: float,
    num_iterations: int,
    device: str,
) -> None:
    """workspace deconvolution; views items are
    (img_addr, img_dims, k1_addr, k1_dims, k2_addr, k2_dims, w_addr, w_dims)."""
    dev = _device(device)
    psi = _wrap(psi_addr, psi_dims)
    images, k1s, k2s, ws = [], [], [], []
    for ia, idims, k1a, k1dims, k2a, k2dims, wa, wdims in views:
        images.append(_wrap(ia, idims))
        k1s.append(_wrap(k1a, k1dims))
        k2s.append(_wrap(k2a, k2dims))
        ws.append(_wrap(wa, wdims))
    _write(psi, api._deconvolve(psi, images, k1s, k2s, ws, num_iterations, lambda_, min_value,
                                "sequential", dev))


def inplace_convolution(im_addr: int, im_dims, kernel_addr: int, kernel_dims, device: str) -> None:
    dev = _device(device)
    im = _wrap(im_addr, im_dims)
    _write(im, api._convolution3d(im, _wrap(kernel_addr, kernel_dims), "circular", dev))


def compute_quotient(input_addr: int, output_addr: int, size: int, device: str) -> None:
    """output = input / output (reference .h:84 pointer semantics)."""
    dev = _device(device)
    out = _wrap_flat(output_addr, size)
    _write(out, api._quotient(_wrap_flat(input_addr, size), out, dev))


def compute_final_values(
    image_addr: int,
    integral_addr: int,
    weight_addr: int,
    size: int,
    min_value: float,
    lambda_: float,
    device: str,
) -> None:
    dev = _device(device)
    psi = _wrap_flat(image_addr, size)
    _write(psi, api._final_values(psi, _wrap_flat(integral_addr, size),
                                  _wrap_flat(weight_addr, size), lambda_, min_value, dev))


def _step_buffers(input_addr, kernel_addr, output_addr, input_dims, kernel_dims):
    """(view, kernel, out) of a single-step call in the reference's legacy
    single-kernel form (.h:90): the view in ``input``, kernel2 the flipped
    kernel1.  The reference treats ``output`` as WRITE-ONLY and starts psi
    from the input buffer (``src/multiviewnative.cu:463-465`` copies input
    to d_image_/d_initial_); so the callers take psi0 = view, and an
    uninitialised output buffer cannot influence the result."""
    view = _wrap(input_addr, input_dims)
    return view, _wrap(kernel_addr, kernel_dims), _wrap(output_addr, input_dims)


def iterate_fft_plain(input_addr: int, kernel_addr: int, output_addr: int, input_dims,
                      kernel_dims, device: str) -> None:
    """``iterate_fft_plain`` (.h:90); write-only ``output``, psi0 = view."""
    dev = _device(device)
    view, kernel, out = _step_buffers(input_addr, kernel_addr, output_addr, input_dims,
                                      kernel_dims)
    _write(out, api._iterate_fft(view, view, kernel, np.flip(kernel), np.ones_like(view), 0.0,
                                 1e-4, dev))


def iterate_fft_tikhonov(input_addr: int, kernel_addr: int, output_addr: int, input_dims,
                         kernel_dims, min_value: float, lambda_: float, device: str) -> None:
    """Tikhonov variant of :func:`iterate_fft_plain`; same write-only
    output contract (``src/multiviewnative.cu:496-595``)."""
    dev = _device(device)
    view, kernel, out = _step_buffers(input_addr, kernel_addr, output_addr, input_dims,
                                      kernel_dims)
    _write(out, api._iterate_fft(view, view, kernel, np.flip(kernel), np.ones_like(view),
                                 lambda_, min_value, dev))


get_num_devices = api.get_num_devices
get_device_name = api.get_device_name
get_device_mem = api.get_device_mem
get_compute_capability = api.get_compute_capability
select_device = api.select_device
