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

Memory: a view step makes each kernel spectrum when it needs it and frees
it after its product, widens the float32 views and weights inside the
operations that read them, and updates in place, so that the loop holds
psi, at most three more volumes of ``dtype`` and cuFFT's work area, however
many views there are.  Every value is the one the plain expressions in the
docstrings give, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch


def wrap_kernel(kernel: torch.Tensor, shape, dtype) -> torch.Tensor:
    """``kernel`` embedded in a zero volume of ``shape`` with its centre
    voxel (``k // 2`` on each axis) at the origin, the negative offsets
    wrapped round (``inc/padd_utils.h:11-40``): the values of
    ``torch.roll(buf, [-(k // 2) ...])`` of the kernel placed at the corner,
    written where they land."""
    if any(k > n for k, n in zip(kernel.shape, shape)):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit {tuple(shape)}")
    buf = torch.zeros(tuple(shape), dtype=dtype, device=kernel.device)
    z, y, x = [(torch.arange(k, device=kernel.device) - k // 2) % n
               for k, n in zip(kernel.shape, shape)]
    buf[z[:, None, None], y[None, :, None], x[None, None, :]] = kernel.to(dtype)
    return buf


def final_values(psi, integral, weight, lam: float, min_value: float):
    """The update of one view step (``ser::regularized_final_values``, and
    ``ser::final_values`` for ``lam == 0``):

        value = psi * integral
        value = where(value > 0, (sqrt(1 + 2 lam value) - 1) / lam, min_value)
        nxt   = where(isfinite(value), clamp(value, min=min_value), min_value)
        return weight * (nxt - psi) + psi

    (``value`` itself in the second line where ``lam == 0``), computed in
    place: ``integral`` is overwritten, and ``lam > 0`` takes one more volume."""
    value = torch.mul(psi, integral, out=integral)
    if lam > 0.0:
        nxt = torch.mul(value, 2.0 * lam).add_(1.0).sqrt_().sub_(1.0).div_(lam)
    else:
        nxt = value
    nxt.masked_fill_(torch.gt(value, 0.0).logical_not_(), min_value)
    finite = torch.isfinite(nxt)
    nxt.clamp_(min=min_value).masked_fill_(finite.logical_not_(), min_value)
    return nxt.sub_(psi).mul_(weight).add_(psi)


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

    def operand(t):
        """``t`` as a view step reads it: as it is where the operation's
        widening to ``dtype`` gives the values ``t.to(dtype)`` holds, else
        converted (and rounded to ``storage``)."""
        if storage is None and torch.promote_types(t.dtype, dtype) == dtype:
            return t
        return rnd(t.to(dtype))

    def convolve(x_hat, kernel):
        """``irfftn(x_hat * rfftn(wrap(kernel)))``, the product in place in
        ``x_hat`` and the kernel's spectrum freed before the inverse."""
        x_hat.mul_(rnd(torch.fft.rfftn(wrap_kernel(kernel, shape, dtype))))
        return torch.fft.irfftn(x_hat, s=shape, dim=dims)

    second = [torch.flip(k, (0, 1, 2)) for k in kernel1] if adjoint_kernel2 else kernel2

    def step(psi, v):
        integral = rnd(convolve(torch.fft.rfftn(psi, dim=dims), kernel1[v]))
        integral = rnd(torch.div(operand(views[v]), integral, out=integral))
        integral = torch.fft.rfftn(integral, dim=dims)  # the quotient freed here
        integral = rnd(convolve(integral, second[v]))
        return rnd(final_values(psi, integral, operand(weights[v]), lam, min_value))

    psi = rnd(psi0.to(dtype))
    for _ in range(iterations):
        for v in range(len(kernel1)):
            psi = step(psi, v)
    return psi
