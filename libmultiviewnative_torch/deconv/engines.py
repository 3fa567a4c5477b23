"""The engine table (:data:`TABLE`): how each engine forwards a kernel into
its operand, takes kernel2's from kernel1's under ``adjoint_kernel2``,
convolves a volume with it and stores it; and which engine a request runs
(:func:`resolve_algorithm`).  Every rung and every estimate asks it."""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from ..core.convolve import convolve_spectrum, direct_convolve3d
from ..core.dft import dft3, dft_convolve_spectrum, full_spectrum, kernel_spectrum_split, make_plan
from ..core.fft import rfft3, stack_spectra
from ..core.shapes import as_shape
from ..core.wrap import wrap_kernel
from ..ops.elementwise import rl_update
from ..ops.fused import (
    _largest_prime_factor,
    check_transposed_shape,
    fused_convolve_spectrum,
    fused_limit,
    kernel_stack_spectrum_fused,
)

ENGINES = ("fft", "dft", "fused", "direct")

# (Z, Y, X) within which fused beat fft at every timed row of 256 per axis
# and up: the longest axes the fused passes served when the CUDA table was
# measured (the 736 is that z limit, not a tile edge of the FFT stages)
FUSED_TIMED = (736, 3632, 1816)
# (Z, Y, X) within which two rows timed past FUSED_TIMED vouch for fused at
# lengths that are products of 2, 3, 5 and 7 (4 views, 10 iterations, NVIDIA
# H100 80GB HBM3 at 700 W, fft / fused it/s in turns): (256, 1024, 2048), x
# tile 8, 5.226 / 6.144 (spread 1.0 %); (1024, 512, 512), z tile 16, 10.156
# / 13.765 (spread 0.1 %)
FUSED_TIMED_SMOOTH = (1816, 3632, 3632)


def select_update(elementwise: str):
    """The update of an ``elementwise`` request: JAX's ``"jnp"`` and
    ``"pallas"`` both run the port's K1 (:func:`..ops.elementwise.rl_update`);
    any other value raises ``ValueError``, as in JAX (``rl.py:50-67``)."""
    if elementwise in ("jnp", "pallas"):
        return rl_update
    raise ValueError(f"unknown elementwise {elementwise!r}")


def apply_update(update_fn, psi, integral, weights, lam, min_value, out):
    """``update_fn``'s result, written to ``out`` when one is given; K1
    writes it there itself."""
    if update_fn is rl_update:
        return rl_update(psi, integral, weights, lam, min_value, out=out)
    res = update_fn(psi, integral, weights, lam, min_value)
    return res if out is None else out.copy_(res)


def auto_device(device) -> torch.device:
    """``device``, or the card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def resolve_algorithm(algorithm: str, spatial_shape, device=None, chunk: bool = False) -> str:
    """The engine a request runs on ``device`` (:func:`auto_device`) for a
    (Z, Y, X) ``spatial_shape``, a batch as one of its volumes; ``chunk``
    marks a streamed rung's halo-extended chunk.  ``"auto"`` on the CPU is
    JAX's rule there (dft up to 256 per axis, fft above), on a CUDA device
    :func:`_cuda_auto`; another name is returned, or raises ``ValueError``
    when unknown."""
    if algorithm != "auto":
        if algorithm not in ENGINES:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        return algorithm
    spatial = tuple(int(s) for s in spatial_shape[-3:])
    dev = auto_device(device)
    if dev.type != "cuda":
        return "dft" if max(spatial) <= 256 else "fft"
    return _cuda_auto(spatial, dev, chunk)


def _cuda_auto(spatial, device: torch.device, chunk: bool) -> str:
    """``"auto"`` on a CUDA device, as ``chip_smoke.py`` phase 22 measured
    on an H100 (``PERF.md`` §6): fused where every axis is at least 256,
    :func:`fused_eligible` holds and :func:`fused_timed`, else fft, never
    dft or fused for a streamed chunk.  Unlike JAX's rule, fft below 256 per
    axis (3.6-3.9x dft) and at (32, 512, 512) (1.18x fused), and fused for a
    batch (JAX's never, ``rl.py:391``)."""
    if not chunk and min(spatial) >= 256 and fused_eligible(spatial, device):
        if fused_timed(spatial):
            return "fused"
    return "fft"


def fused_timed(spatial) -> bool:
    """Whether a fused-eligible (Z, Y, X) shape is of a class where fused
    was timed against fft: within :data:`FUSED_TIMED`, or within
    :data:`FUSED_TIMED_SMOOTH` with no generic radix stage.  Narrower tiles,
    generic radices and the long axes the passes serve through HBM (past
    14528, or a prime factor over 1024) were never timed, and take fft."""
    if all(n <= m for n, m in zip(spatial, FUSED_TIMED)):
        return True
    if any(n > m for n, m in zip(spatial, FUSED_TIMED_SMOOTH)):
        return False
    return all(_largest_prime_factor(n) <= 7 for n in spatial)


def fused_eligible(spatial_shape, device=None) -> bool:
    """Whether ``algorithm="fused"`` can serve this (Z, Y, X) shape on
    ``device`` (:func:`..ops.fused.fused_limit`): every axis a multiple of 8,
    and on a CUDA device each axis at most 2^25, the kernels' limit."""
    Z, Y, X = (int(s) for s in spatial_shape[-3:])
    return fused_limit((Z, X, Y), device) is None


def check_adjoint(kernel1: torch.Tensor) -> None:
    """``adjoint_kernel2`` needs odd kernel1 dims: the true adjoint kernel's
    center k-1-(k//2) is the k//2 floor-center convention only for those."""
    if any(int(d) % 2 == 0 for d in kernel1.shape[-3:]):
        raise ValueError(
            f"adjoint_kernel2 requires odd kernel1 dims; got {tuple(kernel1.shape[-3:])}"
        )


def prepare_spectra(kernels: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """Wrap + forward-FFT a (V, kz, ky, kx) kernel stack (the reference's
    per-view setup loop, ``src/multiviewnative.cpp:146-174``), one view at a
    time so every slice has the memory order rfft3 gives a volume."""
    return stack_spectra(_fft_views(kernels, as_shape(spatial_shape)))


def prepare_spectra_fused(kernels: torch.Tensor, spatial_shape: Sequence[int]):
    """The (V, Kxp, Z, Y) re/im pair of a (V, kz, ky, kx) kernel stack's
    fused spectra, the whole stack forwarded at once
    (:func:`..ops.fused.kernel_stack_spectrum_fused`)."""
    return kernel_stack_spectrum_fused(kernels, as_shape(spatial_shape))


def prepare_spectra_split(kernels: torch.Tensor, spatial_shape: Sequence[int]):
    """The (re, im) pair of a (V, kz, ky, kx) kernel stack's spectra in the
    :func:`..core.dft.dft3` layout (JAX ``rl.py:261-268``)."""
    spatial = as_shape(spatial_shape)
    wrapped = torch.stack([wrap_kernel(k.to(torch.float32), spatial) for k in kernels])
    return dft3(wrapped, make_plan(spatial, kernels.device))


def _fft_views(kernels, spatial) -> list:
    return [rfft3(wrap_kernel(k, spatial)) for k in kernels]


def _fused_views(kernels, spatial) -> list:
    """Each kernel's (re, im) pair, those of one shape forwarded as a stack."""
    ops = [None] * len(kernels)
    for shape in dict.fromkeys(tuple(k.shape) for k in kernels):
        views = [v for v, k in enumerate(kernels) if tuple(k.shape) == shape]
        re, im = kernel_stack_spectrum_fused(torch.stack([kernels[v] for v in views]), spatial)
        for i, v in enumerate(views):
            ops[v] = (re[i], im[i])
    return ops


class Engine(NamedTuple):
    stack: Callable  # (V, kz, ky, kx) kernels, spatial -> the stack's operand
    views: Callable  # kernels, spatial -> one operand per kernel
    adjoint: Callable  # kernel1's operand -> (kernel2's, conj_k2)
    convolve: Callable  # (volume, one view's operand) -> volume
    volumes: Callable  # spatial -> f32 volumes of one kernel's operand
    check: Callable = lambda spatial, device: None  # raises where it cannot serve


TABLE = {
    # a complex hermitian half-spectrum; the adjoint conjugates on the fly
    "fft": Engine(prepare_spectra, _fft_views, lambda op: (op, True), convolve_spectrum,
                  lambda spatial: 1),
    # an (re, im) pair: the compact plan's half-spectrum, or the full
    # spectrum past core.dft's dense limit; the adjoint negates im
    "dft": Engine(prepare_spectra_split,
                  lambda kernels, spatial: [kernel_spectrum_split(k, spatial) for k in kernels],
                  lambda op: ((op[0], -op[1]), False),
                  lambda x, op: dft_convolve_spectrum(x, *op),
                  lambda spatial: 2 if full_spectrum(spatial) else 1),
    # an (re, im) pair, X/2 + 8 of X wide, counted as the JAX package's full
    # pair (a volume of margin at 256³); the adjoint conjugates on the fly
    "fused": Engine(prepare_spectra_fused, _fused_views, lambda op: (op, True),
                    lambda x, op: fused_convolve_spectrum(x, *op), lambda spatial: 2,
                    lambda s, device: check_transposed_shape((s[0], s[2], s[1]), device)),
    # the kernels themselves; the adjoint flips kernel1
    "direct": Engine(lambda kernels, spatial: kernels, lambda kernels, spatial: list(kernels),
                     lambda op: (torch.flip(op, dims=(-3, -2, -1)), False),
                     lambda x, op: direct_convolve3d(x, op, mode="circular"), lambda spatial: 0),
}


def forward(engine: str, kernel1, kernel2, spatial, device, adjoint: bool = False,
            per_view: bool = False):
    """(k1, k2, conj_k2) of two sets of kernels on ``device`` at a (Z, Y, X)
    shape: (V, kz, ky, kx) stacks forwarded whole, or with ``per_view`` one
    operand a kernel; with ``adjoint``, k2 comes from k1."""
    e = TABLE[engine]
    e.check(spatial, device)
    fwd = e.views if per_view else e.stack
    k1 = fwd(kernel1, spatial)
    if adjoint:
        return (k1,) + e.adjoint(k1)
    return k1, fwd(kernel2, spatial), False


def spectrum_volumes(engine: str, spatial, adjoint: bool = False) -> int:
    """The f32 volumes one view's kernel1 and kernel2 operands are counted
    at a (Z, Y, X) shape.  With ``adjoint``, a pair of two volumes counts
    three: dft makes kernel2's negated imaginary part alone, and fused, which
    conjugates on the fly, keeps that volume as margin, as fft keeps its
    whole kernel2."""
    per = TABLE[engine].volumes(spatial)
    return 2 * per - (1 if adjoint and per == 2 else 0)
