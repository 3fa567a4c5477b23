"""Flat functional API: the parity surface of the reference's C ABI.

Counterpart of ``libmultiviewnative_tpu/api.py``.  Every ``extern "C"``
entry point of the reference (``inc/multiviewnative.h:43-109``) has a
numpy-in/numpy-out function here, in the shapes a JNA/ctypes shim marshals
(the shim is ``native/bridge.cpp``, through :mod:`.native_entry`).  The
reference mutates ``psi`` in place through raw pointers; here each call
returns the new array, and the shim copies it back into the caller's buffer.

Every function takes ``device`` (the card by default) and runs there: the
numpy inputs are copied once into tensors on it, and the result is read
back.  On the card the hand kernels run: K2 (quotient) and K1 (update)
for the single-step helpers, K1-K3 through the fft engine for the
convolution, the view steps and the deconvolution.  The plain versions of
``core/kernels.py`` run only for CPU tensors, inside the same wrappers.

| reference symbol                              | here                      |
|-----------------------------------------------|---------------------------|
| inplace_cpu_deconvolve (.h:46)                | deconvolve_flat(device="cpu") |
| inplace_gpu_deconvolve (.h:55)                | deconvolve_flat           |
| inplace_cpu_convolution (.h:50)               | convolution3d(device="cpu") |
| inplace_gpu_convolution (.h:60)               | convolution3d             |
| convolution3DfftCUDAInPlace{,_core} (.h:64-77)| convolution3d             |
| compute_quotient (.h:84)                      | quotient_flat             |
| compute_final_values (.h:86)                  | final_values_flat         |
| iterate_fft_plain (.h:90)                     | iterate_fft_plain         |
| iterate_fft_tikhonov (.h:95)                  | iterate_fft_tikhonov      |
| getNumDevicesCUDA (.h:101)                    | get_num_devices           |
| getNameDeviceCUDA (.h:103)                    | get_device_name           |
| getMemDeviceCUDA (.h:105)                     | get_device_mem            |
| getMaxThreadsDeviceCUDA (.h:99)               | get_device_info           |
| selectDeviceWithHighestComputeCapability (.h:107) | select_device         |
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.convolve import fft_convolve3d
from .deconv.rl import deconvolve, prepare_spectra, rl_view_step
from .deconv.workspace import MultiViewData, pad_kernel_to
from .ops.elementwise import quotient, rl_update


def _tensor(a, device: torch.device) -> torch.Tensor:
    """One float32 array as a tensor on ``device`` (one copy)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _stack(arrays: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    """(V, ...) tensor on ``device`` filled one array at a time: no host
    stack of all of them first."""
    out = torch.empty((len(arrays),) + tuple(np.shape(arrays[0])), device=device)
    for v, a in enumerate(arrays):
        out[v].copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# Each function below is a numpy wrapper of a private one that returns the
# result as a tensor where it was computed: native_entry copies that straight
# into the caller's buffer, with no host array in between.


def _deconvolve(psi, images, kernels1, kernels2, weights, num_iterations, lambda_, min_value,
                view_order, device) -> torch.Tensor:
    dev = torch.device(device)
    k1_shape = tuple(max(int(k.shape[d]) for k in kernels1) for d in range(3))
    k2_shape = tuple(max(int(k.shape[d]) for k in kernels2) for d in range(3))
    data = MultiViewData(
        views=_stack(images, dev),
        kernel1=_stack([pad_kernel_to(np.asarray(k), k1_shape) for k in kernels1], dev),
        kernel2=_stack([pad_kernel_to(np.asarray(k), k2_shape) for k in kernels2], dev),
        weights=_stack(weights, dev),
    )
    return deconvolve(
        _tensor(psi, dev), data, int(num_iterations), lam=float(lambda_),
        min_value=float(min_value), view_order=view_order, algorithm="fft",
    )


def deconvolve_flat(
    psi: np.ndarray,
    images: Sequence[np.ndarray],
    kernels1: Sequence[np.ndarray],
    kernels2: Sequence[np.ndarray],
    weights: Sequence[np.ndarray],
    num_iterations: int,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    device="cuda",
) -> np.ndarray:
    """Full multi-view RL: ``inplace_cpu_deconvolve``
    (``inc/multiviewnative.h:46``, impl ``src/multiviewnative.cpp:244-256``)
    and its GPU twin (.h:55), on the fft engine (the JAX function's
    ``deconvolve_jit`` default).  Kernels of different shapes are centre-
    padded to the largest.  Returns the deconvolved psi."""
    return _numpy(_deconvolve(psi, images, kernels1, kernels2, weights, num_iterations,
                              lambda_, min_value, view_order, device))


def _convolution3d(image, kernel, mode, device) -> torch.Tensor:
    dev = torch.device(device)
    return fft_convolve3d(_tensor(image, dev), _tensor(kernel, dev), mode=mode)


def convolution3d(
    image: np.ndarray, kernel: np.ndarray, mode: str = "circular", device="cuda"
) -> np.ndarray:
    """Single 3D FFT convolution: ``inplace_cpu_convolution``
    (``inc/multiviewnative.h:50``, impl ``src/multiviewnative.cpp:273-293``),
    ``inplace_gpu_convolution`` (.h:60) and the legacy Fiji path
    ``convolution3DfftCUDAInPlace`` (.h:64, impl ``src/multiviewnative.cu:199-238``)."""
    return _numpy(_convolution3d(image, kernel, mode, device))


def _quotient(input_image, output_image, device) -> torch.Tensor:
    dev = torch.device(device)
    return quotient(_tensor(input_image, dev), _tensor(output_image, dev))


def quotient_flat(input_image: np.ndarray, output_image: np.ndarray, device="cuda") -> np.ndarray:
    """input · (1/output), K2: ``compute_quotient``
    (``inc/multiviewnative.h:84``, impl ``src/multiviewnative.cu:321-355``)."""
    return _numpy(_quotient(input_image, output_image, device))


def _final_values(psi, integral, weights, lambda_, min_value, device) -> torch.Tensor:
    dev = torch.device(device)
    return rl_update(_tensor(psi, dev), _tensor(integral, dev), _tensor(weights, dev),
                     float(lambda_), float(min_value))


def final_values_flat(
    psi: np.ndarray,
    integral: np.ndarray,
    weights: np.ndarray,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
    device="cuda",
) -> np.ndarray:
    """One clamped multiplicative update, K1: ``compute_final_values``
    (``inc/multiviewnative.h:86``, impl ``src/multiviewnative.cu:357-393``).
    Like the reference, lambda > 0 selects the Tikhonov variant."""
    return _numpy(_final_values(psi, integral, weights, lambda_, min_value, device))


def _iterate_fft(psi, image, kernel1, kernel2, weights, lambda_, min_value,
                 device) -> torch.Tensor:
    dev = torch.device(device)
    spatial = tuple(np.shape(psi))
    k1 = prepare_spectra(_tensor(kernel1, dev)[None], spatial)[0]
    k2 = prepare_spectra(_tensor(kernel2, dev)[None], spatial)[0]
    return rl_view_step(
        _tensor(psi, dev), _tensor(image, dev), k1, k2, _tensor(weights, dev),
        float(lambda_), float(min_value),
    )


def iterate_fft_plain(
    psi, image, kernel1, kernel2, weights, min_value: float = 1e-4, device="cuda"
) -> np.ndarray:
    """One full RL view step, plain update: ``iterate_fft_plain``
    (``inc/multiviewnative.h:90``, impl ``src/multiviewnative.cu:395-494``)."""
    return _numpy(_iterate_fft(psi, image, kernel1, kernel2, weights, 0.0, min_value, device))


def iterate_fft_tikhonov(
    psi,
    image,
    kernel1,
    kernel2,
    weights,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
    device="cuda",
) -> np.ndarray:
    """One full RL view step, Tikhonov update: ``iterate_fft_tikhonov``
    (``inc/multiviewnative.h:95``, impl ``src/multiviewnative.cu:496-595``)."""
    return _numpy(_iterate_fft(psi, image, kernel1, kernel2, weights, lambda_, min_value,
                               device))


# ---------------------------------------------------------------------------
# Device queries: the reference's CUDA device surface
# (inc/multiviewnative.h:99-109, impl inc/cuda_helpers.cuh:47-136) over
# torch.cuda.  Each raises where the card does not exist.
# ---------------------------------------------------------------------------


def _props(device_id: int):
    n = torch.cuda.device_count()
    if not 0 <= int(device_id) < n:
        raise RuntimeError(f"no CUDA device {device_id}: this host has {n}")
    return torch.cuda.get_device_properties(int(device_id))


def get_num_devices() -> int:
    """``getNumDevicesCUDA`` (.h:101): 0 on a host without a card."""
    return torch.cuda.device_count()


def get_device_name(device_id: int = 0) -> str:
    """``getNameDeviceCUDA`` (.h:103)."""
    return _props(device_id).name


def get_device_mem(device_id: int = 0) -> int:
    """``getMemDeviceCUDA`` (.h:105): bytes of device memory."""
    return int(_props(device_id).total_memory)


def get_compute_capability(device_id: int = 0):
    """``getCUDAcomputeCapability{Major,Minor}Version``: (major, minor), the
    reference's CUDA properties (``inc/cuda_helpers.cuh:70-82``)."""
    props = _props(device_id)
    return int(props.major), int(props.minor)


def get_device_info(device_id: int = 0) -> dict:
    """``getMaxThreadsDeviceCUDA`` + ``selectDeviceWithHighestComputeCapability``
    analog (.h:99,107): one structured record per device."""
    props = _props(device_id)
    dist = torch.distributed
    return {
        "id": int(device_id),
        "platform": "gpu",
        "kind": props.name,
        "process_index": dist.get_rank() if dist.is_available() and dist.is_initialized() else 0,
        "memory_bytes": int(props.total_memory),
    }


def select_device() -> int:
    """``selectDeviceWithHighestComputeCapability`` (.h:107): the first card
    of the highest compute capability."""
    n = get_num_devices()
    if n == 0:
        raise RuntimeError("no CUDA device to select")
    return max(range(n), key=lambda i: (get_compute_capability(i), -i))
