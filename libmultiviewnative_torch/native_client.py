"""ctypes client of the port's C ABI library: what a JNA/Fiji caller does,
from Python.

Counterpart of ``libmultiviewnative_tpu/native_client.py``.  Loads
``libmultiviewnative_torch.so`` (built by :mod:`.native._build` at first
use) and exposes the reference C ABI (``inc/multiviewnative.h``) with
ctypes structs.  Used by the ABI parity checks; also a reference for how
external hosts bind the library.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np
import torch

from .native import _build

_FLOATP = ctypes.POINTER(ctypes.c_float)
_INTP = ctypes.POINTER(ctypes.c_int)


class ViewData(ctypes.Structure):
    """ABI twin of struct view_data (reference inc/multiviewnative.h:15-26)."""

    _fields_ = [
        ("image_", _FLOATP),
        ("kernel1_", _FLOATP),
        ("kernel2_", _FLOATP),
        ("weights_", _FLOATP),
        ("image_dims_", _INTP),
        ("kernel1_dims_", _INTP),
        ("kernel2_dims_", _INTP),
        ("weights_dims_", _INTP),
    ]


class WorkspaceStruct(ctypes.Structure):
    """ABI twin of struct workspace (reference inc/multiviewnative.h:28-35)."""

    _fields_ = [
        ("data_", ctypes.POINTER(ViewData)),
        ("num_views_", ctypes.c_ushort),
        ("lambda_", ctypes.c_double),
        ("minValue_", ctypes.c_float),
        ("num_iterations_", ctypes.c_int),
    ]


def build_native(force: bool = False) -> str:
    """Build the library with the port's builder (keyed by a hash of its
    sources, so never stale); ``force`` rebuilds it all the same.  Returns
    the .so path."""
    return str(_build.build(force=force))


_CONV = [_FLOATP, _INTP, _FLOATP, _INTP, ctypes.c_int]
_SIGNATURES = {
    "inplace_cpu_deconvolve": ([_FLOATP, WorkspaceStruct, ctypes.c_int], None),
    "inplace_gpu_deconvolve": ([_FLOATP, WorkspaceStruct, ctypes.c_int], None),
    "inplace_cpu_convolution": (_CONV, None),
    "inplace_gpu_convolution": (_CONV, None),
    "convolution3DfftCUDAInPlace": (_CONV, None),
    "convolution3DfftCUDAInPlace_core": (_CONV, None),
    "compute_quotient": ([_FLOATP, _FLOATP, ctypes.c_size_t, ctypes.c_int], None),
    "compute_final_values": (
        [_FLOATP, _FLOATP, _FLOATP, ctypes.c_size_t, ctypes.c_float, ctypes.c_double,
         ctypes.c_int],
        None,
    ),
    "iterate_fft_plain": ([_FLOATP, _FLOATP, _FLOATP, _INTP, _INTP, ctypes.c_int], None),
    "iterate_fft_tikhonov": (
        [_FLOATP, _FLOATP, _FLOATP, _INTP, _INTP, ctypes.c_size_t, ctypes.c_float,
         ctypes.c_double, ctypes.c_int],
        None,
    ),
    "selectDeviceWithHighestComputeCapability": ([], ctypes.c_int),
    "getNumDevicesCUDA": ([], ctypes.c_int),
    "getNameDeviceCUDA": ([ctypes.c_int, ctypes.c_char_p], None),
    "getMemDeviceCUDA": ([ctypes.c_int], ctypes.c_longlong),
    "getCUDAcomputeCapabilityMajorVersion": ([ctypes.c_int], ctypes.c_int),
    "getCUDAcomputeCapabilityMinorVersion": ([ctypes.c_int], ctypes.c_int),
    "mvn_tpu_initialize": ([], ctypes.c_int),
    "mvn_tpu_finalize": ([], None),
    "mvn_tpu_last_error": ([], ctypes.c_char_p),
}


def load_native(path: Optional[str] = None) -> ctypes.CDLL:
    """Load the library (built at first use) with every symbol typed."""
    lib = ctypes.CDLL(path or build_native(), mode=ctypes.RTLD_GLOBAL)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FLOATP)


def _dims(a: np.ndarray):
    return (ctypes.c_int * 3)(*a.shape)


def _card_index(device) -> Optional[int]:
    """None for the CPU, else the CUDA index ``device`` names (0 for "cuda")."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    return 0 if dev.index is None else dev.index


class NativeWorkspace:
    """Builds and OWNS the C structs + dims arrays for a deconvolve call
    (keeps every buffer alive for the duration)."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        kernels1: Sequence[np.ndarray],
        kernels2: Sequence[np.ndarray],
        weights: Sequence[np.ndarray],
        lambda_: float = 0.0,
        min_value: float = 1e-4,
        num_iterations: int = 1,
    ) -> None:
        n = len(images)
        self._keep: List[object] = []
        self.views = (ViewData * n)()
        for v in range(n):
            arrs = [
                np.ascontiguousarray(a, np.float32)
                for a in (images[v], kernels1[v], kernels2[v], weights[v])
            ]
            dims = [_dims(a) for a in arrs]
            self._keep += arrs + dims
            self.views[v] = ViewData(*(_fptr(a) for a in arrs), *dims)
        self.struct = WorkspaceStruct(
            ctypes.cast(self.views, ctypes.POINTER(ViewData)),
            n,
            float(lambda_),
            float(min_value),
            int(num_iterations),
        )


def native_deconvolve(
    lib: ctypes.CDLL, psi: np.ndarray, ws: NativeWorkspace, device="cuda"
) -> np.ndarray:
    """Run ``inplace_gpu_deconvolve`` on the card ``device`` names
    (``inplace_cpu_deconvolve`` for ``"cpu"``) through the C ABI; psi is
    mutated in place."""
    psi = np.ascontiguousarray(psi, np.float32)
    card = _card_index(device)
    if card is None:
        lib.inplace_cpu_deconvolve(_fptr(psi), ws.struct, 1)
    else:
        lib.inplace_gpu_deconvolve(_fptr(psi), ws.struct, card)
    return psi


def native_convolution(
    lib: ctypes.CDLL, image: np.ndarray, kernel: np.ndarray, device="cuda"
) -> np.ndarray:
    """Run ``inplace_gpu_convolution`` (``inplace_cpu_convolution`` for
    ``"cpu"``) through the C ABI; the image is mutated in place."""
    image = np.ascontiguousarray(image, np.float32)
    kernel = np.ascontiguousarray(kernel, np.float32)
    card = _card_index(device)
    args = (_fptr(image), _dims(image), _fptr(kernel), _dims(kernel))
    if card is None:
        lib.inplace_cpu_convolution(*args, 1)
    else:
        lib.inplace_gpu_convolution(*args, card)
    return image
