"""3D real convolution transform by dense matrix products (the matmul-DFT
engine), with a mixed-radix (Cooley-Tukey) split for long axes.

Counterpart of ``libmultiviewnative_tpu/core/dft.py``; the same plans, the
same stages and the same einsums, run as ``torch.einsum`` (cuBLAS on the
card).  The JAX package computes these products outside any Pallas kernel,
so they have no hand kernel here.

* real rfft along the last (x) axis via cos/sin matrices,
* full complex DFT along y and z,
* pointwise spectral multiply,
* inverse transforms with the hermitian doubling weights and 1/N folded into
  the last-axis matrix, producing the real volume directly.

Plans are built once per (shape, device) in float64 with numpy and cast to
float32.  Axes of at most 256 take the compact plan (:class:`DFTPlan`, x
halved to X//2+1); a longer axis takes :class:`FullDFTPlan`, with one
decimation-in-time split N = R·M per long axis (:func:`_pick_split`).

Precision: every product runs in fp32 whatever the caller set for matmuls
(:func:`..utils.precision.fp32_matmuls`).  :func:`set_matmul_precision` and
``LMVN_MATMUL_PRECISION`` take the JAX package's names: ``"highest"`` is
fp32, and ``"high"`` (JAX's bf16_3x) is accepted and runs fp32 too, which
meets the tighter contract.  Nothing global in ``torch`` is changed.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.precision import fp32_matmuls
from .wrap import wrap_kernel

_PRECISIONS = ("highest", "high")
_PREC = os.environ.get("LMVN_MATMUL_PRECISION", "highest")
if _PREC not in _PRECISIONS:
    _PREC = "highest"


def set_matmul_precision(name: str) -> None:
    """Select the precision name of the DFT products: ``"highest"``
    (default) or ``"high"``.  Both run fp32 on this port (the JAX package's
    ``"high"`` is bf16_3x, whose error fp32 stays under)."""
    global _PREC
    if name not in _PRECISIONS:
        raise KeyError(name)
    _PREC = name


_DENSE_LIMIT = 256  # above this an axis uses the mixed-radix split


class AxisPlan(NamedTuple):
    """One axis of a full-complex transform: dense or split (N = R*M)."""

    n: int
    kind: str  # 'dense' | 'split'
    cm: torch.Tensor  # dense: (N, N) cos; split: (M, M) cos
    sm: torch.Tensor  # matching sin
    twc: torch.Tensor  # split twiddles (R, M) cos; dense: unused (1, 1)
    tws: torch.Tensor
    oc: torch.Tensor  # split combine (R, R) cos; dense: unused
    osn: torch.Tensor
    r: int
    m: int


class FullDFTPlan(NamedTuple):
    """Full-complex 3D plan for long-axis shapes (any axis > 256): the x axis
    carries the full spectrum, so every axis uses the same dense/split
    machinery; the inverse still emits the real volume."""

    axes: Tuple[AxisPlan, AxisPlan, AxisPlan]  # (z, y, x)
    shape: Tuple[int, int, int]


class DFTPlan(NamedTuple):
    """Constant twiddle matrices for one (z, y, x) shape of at most 256 per
    axis."""

    fcx: torch.Tensor  # forward x (real -> half spectrum), (X, Kx)
    fsx: torch.Tensor
    cy: torch.Tensor  # y and z, (N, N)
    sy: torch.Tensor
    cz: torch.Tensor
    sz: torch.Tensor
    bcx: torch.Tensor  # inverse x with hermitian weights and 1/X, (Kx, X)
    bsx: torch.Tensor
    shape: Tuple[int, int, int]

    @property
    def kx(self) -> int:
        return self.fcx.shape[1]


def _pick_split(n: int):
    """N = R*M with M as close to 128 as possible (64 <= M <= 256,
    R <= 16); None stays dense."""
    best = None
    for r in range(2, 17):
        if n % r:
            continue
        m = n // r
        if 64 <= m <= _DENSE_LIMIT:
            score = abs(m - 128)
            if best is None or score < best[0]:
                best = (score, r, m)
    return None if best is None else (best[1], best[2])


def _cs(a: int, b: int, denom: int):
    theta = 2.0 * np.pi * np.outer(np.arange(a), np.arange(b)) / denom
    return np.cos(theta), np.sin(theta)


def _axis_plan(n: int, device: torch.device) -> AxisPlan:
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    split = _pick_split(n) if n > _DENSE_LIMIT else None
    if split is None:
        c, s = _cs(n, n, n)
        one = torch.zeros((1, 1), device=device)
        return AxisPlan(n, "dense", f32(c), f32(s), one, one, one, one, 1, n)
    r, m = split
    cm, sm = _cs(m, m, m)
    twc, tws = _cs(r, m, n)  # e^{-2 pi i r p / N}
    oc, osn = _cs(r, r, r)
    return AxisPlan(n, "split", f32(cm), f32(sm), f32(twc), f32(tws), f32(oc), f32(osn), r, m)


def full_spectrum(shape) -> bool:
    """Whether a (z, y, x) shape takes the :class:`FullDFTPlan`."""
    return max(int(s) for s in shape[-3:]) > _DENSE_LIMIT


def make_plan(shape, device="cuda"):
    """The transform plan of a (z, y, x) shape on ``device`` (the card by
    default), cached: the compact plan when every axis is at most 256, else
    a :class:`FullDFTPlan`."""
    return _make_plan(tuple(int(s) for s in shape[-3:]), str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _make_plan(shape: Tuple[int, int, int], device: str):
    dev = torch.device(device)
    z, y, x = shape
    if full_spectrum(shape):
        return FullDFTPlan(
            axes=(_axis_plan(z, dev), _axis_plan(y, dev), _axis_plan(x, dev)), shape=shape
        )
    kx = x // 2 + 1
    cx_full, sx_full = _cs(x, x, x)
    cy, sy = _cs(y, y, y)
    cz, sz = _cs(z, z, z)
    # inverse x from the half spectrum with doubling weights:
    # out[n] = (1/N) sum_k w_k (re_k cos - im_k sin), w_0 = w_{N/2} = 1
    w = np.full(kx, 2.0)
    w[0] = 1.0
    if x % 2 == 0:
        w[-1] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return DFTPlan(
        fcx=f32(cx_full[:, :kx]), fsx=f32(-sx_full[:, :kx]),
        cy=f32(cy), sy=f32(sy), cz=f32(cz), sz=f32(sz),
        bcx=f32(w[:, None] * cx_full[:kx, :] / x), bsx=f32(w[:, None] * sx_full[:kx, :] / x),
        shape=shape,
    )


@functools.lru_cache(maxsize=256)
def _complex_axis(n: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The complex64 (N, N) forward and inverse DFT matrices of a full-complex
    y or z stage of the compact convolve (dense: N is at most 256); the
    inverse without its 1/N."""
    c, s = _cs(n, n, n)
    f = lambda a: torch.as_tensor(np.asarray(a, np.complex64), device=torch.device(device))
    return f(c - 1j * s), f(c + 1j * s)


_EINSUM = torch.einsum

# ---------------------------------------------------------------------------
# Full-complex per-axis machinery (long-axis mode)
# ---------------------------------------------------------------------------


def _reshape_axis(a, pos: int, new_dims):
    """Replace the axis at position ``pos`` from the end with ``new_dims``."""
    idx = a.ndim - pos
    return a.reshape(a.shape[:idx] + tuple(new_dims) + a.shape[idx + 1 :])


def _merge_axis_pair(a, pos: int, n: int):
    """Merge the two adjacent axes ending at position ``pos`` from the end
    into one of size n."""
    idx = a.ndim - pos - 1
    return a.reshape(a.shape[:idx] + (n,) + a.shape[idx + 2 :])


def _axis_fwd(re, im, ap: AxisPlan, pos: int):
    """Forward DFT along the axis ``pos`` from the end (1 = last); ``im`` None
    marks real input."""
    tail = "ab"[: pos - 1]
    if ap.kind == "dense":
        spec = f"...m{tail},mp->...p{tail}"
        nre = _EINSUM(spec, re, ap.cm)
        nim = -_EINSUM(spec, re, ap.sm)
        if im is not None:
            nre = nre + _EINSUM(spec, im, ap.sm)
            nim = nim + _EINSUM(spec, im, ap.cm)
        return nre, nim
    R, M = ap.r, ap.m
    re2 = _reshape_axis(re, pos, (M, R))  # n = R*m + r
    im2 = None if im is None else _reshape_axis(im, pos, (M, R))
    spec1 = f"...mr{tail},mp->...rp{tail}"
    fre = _EINSUM(spec1, re2, ap.cm)
    fim = -_EINSUM(spec1, re2, ap.sm)
    if im2 is not None:
        fre = fre + _EINSUM(spec1, im2, ap.sm)
        fim = fim + _EINSUM(spec1, im2, ap.cm)
    bshape = (R, M) + (1,) * (pos - 1)
    twc, tws = ap.twc.reshape(bshape), ap.tws.reshape(bshape)
    gre = fre * twc + fim * tws
    gim = fim * twc - fre * tws
    # R-point combine: X[q, p] = sum_r G[r, p] e^{-2 pi i r q / R}
    spec2 = f"...rp{tail},rq->...qp{tail}"
    xre = _EINSUM(spec2, gre, ap.oc) + _EINSUM(spec2, gim, ap.osn)
    xim = _EINSUM(spec2, gim, ap.oc) - _EINSUM(spec2, gre, ap.osn)
    return _merge_axis_pair(xre, pos, ap.n), _merge_axis_pair(xim, pos, ap.n)


def _axis_inv(re, im, ap: AxisPlan, pos: int, real_out: bool = False):
    """Inverse DFT along axis ``pos`` from the end, scaled by 1/N; with
    ``real_out`` only the real part."""
    tail = "ab"[: pos - 1]
    inv_n = 1.0 / ap.n
    if ap.kind == "dense":
        spec = f"...p{tail},pm->...m{tail}"
        nre = (_EINSUM(spec, re, ap.cm) - _EINSUM(spec, im, ap.sm)) * inv_n
        if real_out:
            return nre, None
        nim = (_EINSUM(spec, im, ap.cm) + _EINSUM(spec, re, ap.sm)) * inv_n
        return nre, nim
    R, M = ap.r, ap.m
    re2 = _reshape_axis(re, pos, (R, M))
    im2 = _reshape_axis(im, pos, (R, M))
    spec2 = f"...qp{tail},qr->...rp{tail}"
    hre = _EINSUM(spec2, re2, ap.oc) - _EINSUM(spec2, im2, ap.osn)
    him = _EINSUM(spec2, im2, ap.oc) + _EINSUM(spec2, re2, ap.osn)
    bshape = (R, M) + (1,) * (pos - 1)
    twc, tws = ap.twc.reshape(bshape), ap.tws.reshape(bshape)
    gre = hre * twc - him * tws
    gim = him * twc + hre * tws
    # M-point inverse over p, emitting (m, r) so the flatten is n = R*m + r
    spec1 = f"...rp{tail},pm->...mr{tail}"
    nre = (_EINSUM(spec1, gre, ap.cm) - _EINSUM(spec1, gim, ap.sm)) * inv_n
    nre = _merge_axis_pair(nre, pos, ap.n)
    if real_out:
        return nre, None
    nim = (_EINSUM(spec1, gim, ap.cm) + _EINSUM(spec1, gre, ap.sm)) * inv_n
    return nre, _merge_axis_pair(nim, pos, ap.n)


def _dft3_full(x, plan: FullDFTPlan):
    azp, ayp, axp = plan.axes
    re, im = _axis_fwd(x, None, axp, 1)
    re, im = _axis_fwd(re, im, ayp, 2)
    return _axis_fwd(re, im, azp, 3)


def _idft3_full(re, im, plan: FullDFTPlan):
    azp, ayp, axp = plan.axes
    re, im = _axis_inv(re, im, azp, 3)
    re, im = _axis_inv(re, im, ayp, 2)
    return _axis_inv(re, im, axp, 1, real_out=True)[0]


def dft3(x: torch.Tensor, plan=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward 3D real DFT over the trailing (z, y, x) axes -> (re, im).

    A compact plan emits the hermitian-halved rfftn layout (last axis
    X//2+1); a :class:`FullDFTPlan` the full spectrum.  ``plan`` defaults to
    :func:`make_plan` of ``x``'s shape and device."""
    if plan is None:
        plan = make_plan(x.shape, x.device)
    with fp32_matmuls():
        if isinstance(plan, FullDFTPlan):
            return _dft3_full(x, plan)
        re = _EINSUM("...zyx,xk->...zyk", x, plan.fcx)
        im = _EINSUM("...zyx,xk->...zyk", x, plan.fsx)
        # y axis: (C - iS)(re + i im)
        re, im = (
            _EINSUM("...zyk,ym->...zmk", re, plan.cy) + _EINSUM("...zyk,ym->...zmk", im, plan.sy),
            _EINSUM("...zyk,ym->...zmk", im, plan.cy) - _EINSUM("...zyk,ym->...zmk", re, plan.sy),
        )
        return (
            _EINSUM("...zmk,zn->...nmk", re, plan.cz) + _EINSUM("...zmk,zn->...nmk", im, plan.sz),
            _EINSUM("...zmk,zn->...nmk", im, plan.cz) - _EINSUM("...zmk,zn->...nmk", re, plan.sz),
        )


def idft3(re: torch.Tensor, im: torch.Tensor, plan) -> torch.Tensor:
    """Inverse of :func:`dft3`, returning the real volume."""
    with fp32_matmuls():
        if isinstance(plan, FullDFTPlan):
            return _idft3_full(re, im, plan)
        z, y, _ = plan.shape
        re, im = (
            (_EINSUM("...nmk,nz->...zmk", re, plan.cz)
             - _EINSUM("...nmk,nz->...zmk", im, plan.sz)) / z,
            (_EINSUM("...nmk,nz->...zmk", im, plan.cz)
             + _EINSUM("...nmk,nz->...zmk", re, plan.sz)) / z,
        )
        re, im = (
            (_EINSUM("...zmk,my->...zyk", re, plan.cy)
             - _EINSUM("...zmk,my->...zyk", im, plan.sy)) / y,
            (_EINSUM("...zmk,my->...zyk", im, plan.cy)
             + _EINSUM("...zmk,my->...zyk", re, plan.sy)) / y,
        )
        return _EINSUM("...zyk,kx->...zyx", re, plan.bcx) - _EINSUM(
            "...zyk,kx->...zyx", im, plan.bsx
        )


def kernel_spectrum_split(kernel: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapped kernel's spectrum as an (re, im) pair in the dft3 layout."""
    wrapped = wrap_kernel(kernel.to(torch.float32), tuple(int(s) for s in shape))
    return dft3(wrapped, make_plan(shape, kernel.device))


def _dft_convolve_complex(x, k_re, k_im, plan: DFTPlan):
    """The compact-plan convolve with complex64 y and z stages, as the JAX
    package runs it (each complex product reads its operand once)."""
    dev = str(x.device)
    z, y, _ = plan.shape
    fy, iy = _complex_axis(y, dev)
    fz, iz = _complex_axis(z, dev)
    re = _EINSUM("...zyx,xk->...zyk", x, plan.fcx)
    im = _EINSUM("...zyx,xk->...zyk", x, plan.fsx)
    u = torch.complex(re, im)
    u = _EINSUM("...yk,ym->...mk", u, fy)
    u = _EINSUM("...zmk,zn->...nmk", u, fz)
    u = u * torch.complex(k_re, k_im)
    u = _EINSUM("...nmk,nz->...zmk", u, iz) * (1.0 / z)
    u = _EINSUM("...mk,my->...yk", u, iy) * (1.0 / y)
    return _EINSUM("...zyk,kx->...zyx", u.real, plan.bcx) - _EINSUM(
        "...zyk,kx->...zyx", u.imag, plan.bsx
    )


def dft_convolve_spectrum(x: torch.Tensor, k_re: torch.Tensor, k_im: torch.Tensor) -> torch.Tensor:
    """Circular convolution with a pre-forwarded split spectrum: the
    matmul-DFT counterpart of :func:`.convolve.convolve_spectrum`."""
    plan = make_plan(x.shape, x.device)
    with fp32_matmuls():
        if isinstance(plan, DFTPlan):
            return _dft_convolve_complex(x, k_re, k_im, plan)
        re, im = _dft3_full(x, plan)
        pre = re * k_re - im * k_im
        pim = re * k_im + im * k_re
        return _idft3_full(pre, pim, plan)
