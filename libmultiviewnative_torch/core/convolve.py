"""3D FFT convolution.

Counterpart of ``libmultiviewnative_tpu/core/convolve.py`` (the reference's
``cpu_convolve``, ``inc/cpu_convolve.h:26-304``):

  * ``half_inplace(forwarded_kernel)`` → :func:`convolve_spectrum`
    (rfft, pointwise multiply through the K3 kernel, irfft: the RL hot path),
  * ``inplace()`` → :func:`fft_convolve3d` (``circular`` = no_padd,
    ``linear`` = zero_padd).

The direct (stencil) engine and the ``convolve3d`` policy are not ported
yet.  Leading axes are batch; the trailing three are (z, y, x).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.elementwise import layout_like, spectral_multiply
from .fft import irfft3, rfft3
from .shapes import as_shape, zero_pad_extents, zero_pad_offsets
from .wrap import wrap_kernel


def convolve_spectrum(
    x: torch.Tensor, kernel_hat: torch.Tensor, conj_k: bool = False
) -> torch.Tensor:
    """Circular-convolve ``x`` with a pre-forwarded kernel spectrum.

    ``conj_k`` multiplies by conj(kernel_hat) instead: the adjoint
    (flipped) kernel for odd kernel dims, without a second spectrum.
    Either operand may carry leading batch axes the other lacks.
    """
    x_hat = rfft3(x)
    if kernel_hat.ndim > x_hat.ndim and not conj_k:
        # one x against a stack of kernels: the product commutes, and the
        # K3 kernel broadcasts its second operand over the first's batch
        x_hat = layout_like(x_hat, kernel_hat[(0,) * (kernel_hat.ndim - x_hat.ndim)])
        prod = spectral_multiply(kernel_hat, x_hat)
    else:
        x_hat = layout_like(x_hat, kernel_hat)  # no copy on the RL main path
        prod = spectral_multiply(x_hat, kernel_hat, conj_k=conj_k, out=x_hat)
    return irfft3(prod, x.shape[-3:])


def fft_convolve3d(
    image: torch.Tensor, kernel: torch.Tensor, mode: str = "circular"
) -> torch.Tensor:
    """One-shot FFT convolution of an image with an unprepared kernel
    (``cpu_convolve::inplace``, ``inc/cpu_convolve.h:147-202``).

    * ``mode="circular"``: the kernel is wrapped into an image-extent
      buffer; the convolution wraps around the volume edges.
    * ``mode="linear"``: the image is embedded at offsets (k-1)//2 inside
      extents image+k-1, convolved circularly there and cropped: linear
      convolution with a zero boundary.
    """
    if mode == "circular":
        k_hat = rfft3(wrap_kernel(kernel, image.shape[-3:]))
        return convolve_spectrum(image, k_hat)
    if mode == "linear":
        spatial = as_shape(image.shape[-3:])
        extents = zero_pad_extents(spatial, kernel.shape)
        offsets = zero_pad_offsets(kernel.shape)
        pad = []
        for o, e, s in reversed(list(zip(offsets, extents, spatial))):
            pad += [o, e - o - s]
        padded = F.pad(image, pad)
        out = convolve_spectrum(padded, rfft3(wrap_kernel(kernel, extents)))
        return out[(...,) + tuple(slice(o, o + s) for o, s in zip(offsets, spatial))]
    raise ValueError(f"unknown mode {mode!r}; expected 'circular' or 'linear'")
