"""Plain multi-view Richardson-Lucy: the benchmark's yardstick.

Eq. 70 of Preibisch et al., arXiv:1308.0730, in the sequential view order
of the reference library's CPU driver (libmultiviewnative,
``src/multiviewnative.cpp:191-228``, ``inc/cpu_kernels.h:29-90``).  One view
step, with circular convolutions through ``torch.fft``:

    integral = psi (x) kernel1
    integral = view / integral
    integral = integral (x) kernel2
    psi      = w * (clamp(regularised(psi * integral)) - psi) + psi

It imports nothing of the program under test and takes nothing the program
made: the wrapped kernels, their spectra and, under ``adjoint_kernel2``, the
flipped kernel1 are worked out again here from the inputs.
"""

from __future__ import annotations

from typing import Optional

import torch


def wrap_kernel(kernel: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``kernel`` embedded in a zero volume of ``shape`` with its centre
    voxel (``k // 2`` on each axis) at the origin, the negative offsets
    wrapped round (``inc/padd_utils.h:11-40``)."""
    buf = torch.zeros(tuple(shape), dtype=dtype, device=kernel.device)
    buf[tuple(slice(0, s) for s in kernel.shape)] = kernel.to(dtype)
    return torch.roll(buf, shifts=[-(s // 2) for s in kernel.shape], dims=(0, 1, 2))


def final_values(psi, integral, weight, lam: float, min_value: float):
    """The update of one view step (``ser::regularized_final_values``, and
    ``ser::final_values`` for ``lam == 0``)."""
    value = psi * integral
    if lam > 0.0:
        candidate = (torch.sqrt(1.0 + 2.0 * lam * value) - 1.0) / lam
    else:
        candidate = value
    value = torch.where(value > 0.0, candidate, torch.full_like(value, min_value))
    nxt = torch.where(torch.isfinite(value), torch.clamp(value, min=min_value),
                      torch.full_like(value, min_value))
    return weight * (nxt - psi) + psi


def _rounder(storage: Optional[torch.dtype], dtype: torch.dtype):
    """Round a stored value to ``storage`` and widen it back to ``dtype``
    (complex values part by part); the identity when ``storage`` is None."""
    if storage is None:
        return lambda t: t

    def rnd(t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            return torch.view_as_complex(torch.view_as_real(t).to(storage).to(dtype))
        return t.to(storage).to(dtype)

    return rnd


def deconvolve(psi0, views, kernel1, kernel2, weights, iterations: int, lam: float,
               min_value: float, adjoint_kernel2: bool = False,
               dtype: torch.dtype = torch.float64,
               storage: Optional[torch.dtype] = None) -> torch.Tensor:
    """``iterations`` sweeps over the views, computed in ``dtype``.

    psi0 is (Z, Y, X) or (B, Z, Y, X); views (V, Z, Y, X) or (V, B, Z, Y, X);
    kernel1 and kernel2 (V, kz, ky, kx); weights (V,), (V, Z, Y, X) or
    (V, B, Z, Y, X).  ``adjoint_kernel2`` takes kernel2 as kernel1 flipped on
    every axis and ignores the given one.  ``storage`` rounds every value
    the loop stores (spectra, each intermediate volume, psi) to that dtype:
    a run at a lower precision than ``dtype``, the benchmark's control."""
    shape = tuple(psi0.shape[-3:])
    rnd = _rounder(storage, dtype)
    dims = (-3, -2, -1)

    def spectrum(k):
        return rnd(torch.fft.rfftn(wrap_kernel(k, shape, dtype)))

    def convolve(x, k_hat):
        return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * k_hat, s=shape, dim=dims)

    k1_hat = [spectrum(k) for k in kernel1]
    second = [torch.flip(k, (0, 1, 2)) for k in kernel1] if adjoint_kernel2 else kernel2
    k2_hat = [spectrum(k) for k in second]
    psi = rnd(psi0.to(dtype))
    for _ in range(iterations):
        for v in range(len(k1_hat)):
            view = rnd(views[v].to(dtype))
            weight = rnd(weights[v].to(dtype))
            integral = rnd(convolve(psi, k1_hat[v]))
            integral = rnd(view / integral)
            integral = rnd(convolve(integral, k2_hat[v]))
            psi = rnd(final_values(psi, integral, weight, lam, min_value))
    return psi
