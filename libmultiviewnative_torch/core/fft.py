"""3D real FFT layer + kernel-spectrum cache.

Counterpart of ``libmultiviewnative_tpu/core/fft.py``.  ``torch.fft``
(cuFFT on the card, pocketfft on the CPU) owns planning and its own plan
cache; :class:`KernelSpectrumCache` keeps the pre-forwarded kernel *data*,
the analog of the reference's ``generate_forwarded_kernels``
(``src/gpu_deconvolve_methods.cuh:28-65``).

Normalization: the inverse applies 1/N, matching the reference's explicit
post-scale loop (``inc/cpu_convolve.h:182-189``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence, Tuple

import torch

from .shapes import Shape, as_shape
from .wrap import wrap_kernel

_DIMS3 = (-3, -2, -1)


def rfft3(x: torch.Tensor) -> torch.Tensor:
    """Forward real 3D FFT over the trailing (z, y, x) axes."""
    return torch.fft.rfftn(x, dim=_DIMS3)


def irfft3(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse real 3D FFT back to the given trailing spatial shape.

    ``shape`` is required: without ``s=`` an odd X would come back as the
    even length 2*(X//2).
    """
    return torch.fft.irfftn(x, s=as_shape(shape)[-3:], dim=_DIMS3)


def stack_spectra(spectra: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack spectra of one shape keeping the first one's memory order in
    every slice.  On CUDA a 3D rfftn comes back permuted ((X//2+1, Z, Y) in
    memory); kernel spectra stacked in that order meet rfft3(x) in the order
    the K3 kernel needs, with no copy per convolution."""
    first = spectra[0]
    strides = (first.numel(),) + tuple(first.stride())
    out = torch.empty_strided(
        (len(spectra),) + tuple(first.shape), strides, dtype=first.dtype, device=first.device
    )
    for i, s in enumerate(spectra):
        out[i].copy_(s)
    return out


def forward_kernel_spectrum(kernel: torch.Tensor, extents: Sequence[int]) -> torch.Tensor:
    """Wrap a PSF to the origin and forward-transform it: the reference's
    "forwarded kernel" (``src/multiviewnative.cpp:146-174``)."""
    return rfft3(wrap_kernel(kernel.to(torch.float32), as_shape(extents)))


class KernelSpectrumCache:
    """Cache of forwarded kernel spectra keyed by kernel identity.

    Lock-protected, LRU-bounded, and holding a strong reference to each
    cached kernel so a recycled ``id()`` can never alias a freed kernel's
    entry.  A spectrum lives on its kernel's device.
    """

    def __init__(self, maxsize: int = 64) -> None:
        self._store: "OrderedDict[Tuple[int, Shape, Shape], tuple]" = OrderedDict()
        self._maxsize = int(maxsize)
        self._lock = threading.Lock()

    def get(self, kernel: torch.Tensor, extents: Sequence[int]) -> torch.Tensor:
        extents = as_shape(extents)
        key = (id(kernel), tuple(kernel.shape), extents)
        with self._lock:
            hit = self._store.get(key)
            if hit is not None and hit[0] is kernel:
                self._store.move_to_end(key)
                return hit[1]
        spectrum = forward_kernel_spectrum(kernel, extents)
        with self._lock:
            self._store[key] = (kernel, spectrum)
            self._store.move_to_end(key)
            while len(self._store) > self._maxsize:
                self._store.popitem(last=False)
        return spectrum

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        return len(self._store)


# The process-wide cache, as the JAX package's ``default_spectrum_cache``.
default_spectrum_cache = KernelSpectrumCache()
