"""3D FFT convolution.

Counterpart of ``libmultiviewnative_tpu/core/convolve.py`` (the reference's
``cpu_convolve``, ``inc/cpu_convolve.h:26-304``):

  * ``half_inplace(forwarded_kernel)`` → :func:`convolve_spectrum`
    (rfft, pointwise multiply through the K3 kernel, irfft: the RL hot path),
  * ``inplace()`` → :func:`fft_convolve3d` (``circular`` = no_padd,
    ``linear`` = zero_padd).

and the direct engine, :func:`direct_convolve3d` (a shift-and-add stencil
for small kernels, ``torch.nn.functional.conv3d`` otherwise), with the
:func:`convolve3d` policy between the two.  Leading axes are batch; the
trailing three are (z, y, x).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.elementwise import layout_like, spectral_multiply
from ..utils.precision import fp32_convs
from ..utils.trace import spanned
from .fft import irfft3, rfft3, stack_spectra
from .shapes import as_shape, halo_widths, zero_pad_extents, zero_pad_offsets
from .wrap import crop_at_offsets, embed_at_offsets, wrap_kernel  # noqa: F401 (re-exported, as in JAX)


@spanned("lmvn.engine.convolve_spectrum")
def convolve_spectrum(
    x: torch.Tensor, kernel_hat: torch.Tensor, conj_k: bool = False
) -> torch.Tensor:
    """Circular-convolve ``x`` with a pre-forwarded kernel spectrum.

    ``conj_k`` multiplies by conj(kernel_hat) instead: the adjoint
    (flipped) kernel for odd kernel dims, without a second spectrum.
    Either operand may carry leading batch axes the other lacks.

    A batch of volumes against one spectrum is transformed one entry at a
    time, so that each entry's result is bitwise that of a call on the
    entry alone (cuFFT's batched plans round otherwise: 1.5e-6 of max|psi|
    after 10 RL iterations at 256³ on an H100, ``scripts/measure_batched.py``),
    and the product is one K3 launch for the batch.
    """
    if x.ndim > kernel_hat.ndim == 3:
        return _convolve_entries(x, kernel_hat, conj_k)
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


def _convolve_entries(x: torch.Tensor, kernel_hat: torch.Tensor, conj_k: bool) -> torch.Tensor:
    """:func:`convolve_spectrum` of a batch ``x`` against one spectrum: the
    entries' spectra stacked in ``kernel_hat``'s memory order, one K3 launch
    over them, and an inverse transform per entry."""
    spatial = tuple(x.shape[-3:])
    entries = x.reshape((-1,) + spatial)
    x_hat = layout_like(stack_spectra([rfft3(e) for e in entries]), kernel_hat)
    prod = spectral_multiply(x_hat, kernel_hat, conj_k=conj_k, out=x_hat)
    return torch.stack([irfft3(p, spatial) for p in prod]).reshape(x.shape)


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


def _pad_for_stencil(image: torch.Tensor, kernel_shape, mode: str) -> torch.Tensor:
    """The image with the kernel's halos on its three trailing axes: wrapped
    (``circular``) or zeros (``linear``).  The wrap gathers by index, so a
    halo may be longer than its axis (``jnp.pad(mode="wrap")`` allows that,
    ``F.pad(mode="circular")`` does not)."""
    lo, hi = halo_widths(kernel_shape)
    if mode == "linear":
        pad = []
        for l, h in zip(reversed(lo), reversed(hi)):
            pad += [l, h]
        return F.pad(image, pad)
    if mode != "circular":
        raise ValueError(f"unknown mode {mode!r}; expected 'circular' or 'linear'")
    out = image
    for axis, (l, h) in enumerate(zip(lo, hi)):
        dim = image.ndim - 3 + axis
        n = image.shape[dim]
        idx = torch.arange(-l, n + h, device=image.device) % n
        out = out.index_select(dim, idx)
    return out


def _stencil_conv(padded: torch.Tensor, kernel: torch.Tensor, spatial) -> torch.Tensor:
    """Shift-and-add stencil: out = sum_m kernel[m] · padded[o_m : o_m + S]
    with o_m = (k-1) - m per axis (out[p] = sum_m k[m]·x[p+c-m], c = k//2,
    lo = k-1-c), in the JAX package's tap order."""
    kz, ky, kx = kernel.shape
    out = None
    for mz in range(kz):
        for my in range(ky):
            for mx in range(kx):
                oz, oy, ox = kz - 1 - mz, ky - 1 - my, kx - 1 - mx
                term = kernel[mz, my, mx] * padded[
                    ..., oz : oz + spatial[0], oy : oy + spatial[1], ox : ox + spatial[2]
                ]
                out = term if out is None else out + term
    return out


def _conv(padded: torch.Tensor, kernel: torch.Tensor, batch_shape, spatial) -> torch.Tensor:
    """The dense stencil as one ``conv3d`` (cuDNN on the card), held to fp32
    (:func:`..utils.precision.fp32_convs`; the JAX package pins
    ``Precision.HIGHEST``).  conv3d computes correlation, so the kernel is
    flipped for true convolution."""
    x = padded.reshape((-1, 1) + tuple(padded.shape[-3:]))
    w = torch.flip(kernel, dims=(0, 1, 2))[None, None].to(x.dtype)
    with fp32_convs():
        out = F.conv3d(x, w)
    return out.reshape(tuple(batch_shape) + tuple(spatial))


_STENCIL_TAP_LIMIT = 256


def direct_convolve3d(
    image: torch.Tensor, kernel: torch.Tensor, mode: str = "circular", stencil: str = "auto"
) -> torch.Tensor:
    """True convolution with a small PSF computed in the spatial domain:
    out[p] = sum_j kernel[j]·x[p + c - j], c = kernel_shape // 2, the same
    math as the FFT path.

    ``mode``: ``circular`` (wrap) or ``linear`` (zeros).  ``stencil``:
    ``"auto"`` (shift-and-add up to 256 taps, else the conv),
    ``"rolls"`` (shift-and-add) or ``"conv"`` (``conv3d``)."""
    spatial = tuple(image.shape[-3:])
    batch_shape = tuple(image.shape[:-3])
    padded = _pad_for_stencil(image, kernel.shape, mode)
    if stencil == "auto":
        stencil = "rolls" if kernel.numel() <= _STENCIL_TAP_LIMIT else "conv"
    if stencil == "rolls":
        return _stencil_conv(padded, kernel.to(image.dtype), spatial)
    if stencil == "conv":
        return _conv(padded, kernel, batch_shape, spatial)
    raise ValueError(f"unknown stencil {stencil!r}")


def convolve3d(
    image: torch.Tensor,
    kernel: torch.Tensor,
    mode: str = "circular",
    algorithm: str = "auto",
    direct_threshold: int = 15**3,
) -> torch.Tensor:
    """Convolve, picking the FFT or the direct engine: ``algorithm`` is
    ``"auto"``, ``"fft"`` or ``"direct"``; ``"auto"`` takes the direct path
    when the kernel has at most ``direct_threshold`` taps."""
    if algorithm == "auto":
        algorithm = "direct" if kernel.numel() <= direct_threshold else "fft"
    if algorithm == "direct":
        return direct_convolve3d(image, kernel, mode=mode)
    if algorithm == "fft":
        return fft_convolve3d(image, kernel, mode=mode)
    raise ValueError(f"unknown algorithm {algorithm!r}")
