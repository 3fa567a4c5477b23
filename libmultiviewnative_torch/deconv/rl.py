"""Richardson-Lucy deconvolution drivers (single device), fft engine.

Counterpart of ``libmultiviewnative_tpu/deconv/rl.py``, and of the
reference's CPU and GPU RL loops (``src/multiviewnative.cpp:101-240``,
``src/gpu_deconvolve_methods.cuh:85-562``).  One view step:

    integral = psi (x) kernel1          # rfft · K3 spectral_multiply · irfft
    integral = view / integral          # K2 quotient
    integral = integral (x) kernel2     # rfft · K3 · irfft
    psi      = w*(clamp(update) - psi) + psi   # K1 rl_update

This is the reference library's own GPU design: cuFFT plus three
elementwise kernels.  On a CUDA device the three are the hand-written
kernels of :mod:`..ops.elementwise`; on the CPU their plain versions.

PyTorch runs eagerly, so there is no ``deconvolve_jit``: :func:`deconvolve`
takes its role, and λ/min_value are runtime values on every call.

Engines: ``"fft"`` is the one engine ported.  ``"auto"`` resolves to
``"fft"`` until the fused engine is ported (ROADMAP queue 2, K4-K10);
:func:`resolve_algorithm` says what a request runs, and the module logger
records it at DEBUG.  ``"dft"``, ``"fused"`` and ``"direct"`` raise
:class:`NotImplementedError`.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import torch

from ..core.convolve import convolve_spectrum
from ..core.fft import rfft3, stack_spectra
from ..core.shapes import as_shape
from ..core.wrap import wrap_kernel
from ..ops.elementwise import quotient, rl_update
from .workspace import MultiViewData, Workspace, check_simultaneous_weights

log = logging.getLogger(__name__)

_NOT_PORTED = {
    "dft": "the matmul-DFT engine is not ported yet (ROADMAP P8)",
    "fused": "the fused RL-step engine is not ported yet (ROADMAP P7, kernels K4-K10)",
    "direct": "the direct stencil engine is not ported yet (ROADMAP P4, direct_convolve3d)",
}


def resolve_algorithm(algorithm: str) -> str:
    """The engine a request runs: ``"auto"`` means ``"fft"`` in the port
    until the fused engine exists; unported engines raise."""
    if algorithm == "auto":
        algorithm = "fft"
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(f"algorithm={algorithm!r}: {_NOT_PORTED[algorithm]}")
    if algorithm != "fft":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return algorithm


def _check_adjoint(kernel1: torch.Tensor) -> None:
    # The true adjoint kernel has center k-1-(k//2), which equals the k//2
    # floor-center convention only for odd dims.
    if any(int(d) % 2 == 0 for d in kernel1.shape[-3:]):
        raise ValueError(
            "adjoint_kernel2 requires odd kernel1 dims; got "
            f"{tuple(kernel1.shape[-3:])}"
        )


def prepare_spectra(kernels: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """Wrap + forward-FFT a (V, kz, ky, kx) kernel stack (the reference's
    per-view setup loop, ``src/multiviewnative.cpp:146-174``), one view at a
    time so every slice has the memory order rfft3 gives a volume."""
    spatial = as_shape(spatial_shape)
    return stack_spectra([rfft3(wrap_kernel(k, spatial)) for k in kernels])


def rl_view_step(
    psi: torch.Tensor,
    view: torch.Tensor,
    k1_hat: torch.Tensor,
    k2_hat: torch.Tensor,
    weights,
    lam,
    min_value: float,
    conj_k2: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One view's multiplicative update (``src/multiviewnative.cpp:191-228``).

    ``conj_k2`` multiplies by conj(k2_hat) (the adjoint of kernel1 when
    k2_hat is kernel1's spectrum).  ``out=psi`` updates psi in place.
    """
    integral = convolve_spectrum(psi, k1_hat)
    integral = quotient(view, integral, out=integral)
    integral = convolve_spectrum(integral, k2_hat, conj_k=conj_k2)
    return rl_update(psi, integral, weights, lam, min_value, out=out)


class PreparedSpectra:
    """Pre-forwarded kernel spectra bound to an (algorithm, shape) pair: the
    serving-path plan store.  ``conj_k2`` marks ``k2`` as kernel1's spectrum,
    to be conjugated on the fly (``adjoint_kernel2``)."""

    def __init__(self, algorithm: str, spatial, k1, k2, conj_k2: bool = False):
        self.algorithm = algorithm
        self.spatial = as_shape(spatial)
        self.k1 = k1
        self.k2 = k2
        self.conj_k2 = bool(conj_k2)


def prepare_workspace(
    data: MultiViewData,
    spatial_shape,
    algorithm: str = "auto",
    adjoint_kernel2: bool = False,
) -> PreparedSpectra:
    """Forward the kernel stacks once for reuse by :func:`deconvolve_prepared`.
    ``"auto"`` resolves as :func:`deconvolve` would."""
    spatial = as_shape(spatial_shape)
    if adjoint_kernel2:
        _check_adjoint(data.kernel1)
    algorithm = resolve_algorithm(algorithm)
    k1 = prepare_spectra(data.kernel1, spatial)
    if adjoint_kernel2:
        return PreparedSpectra(algorithm, spatial, k1, k1, conj_k2=True)
    return PreparedSpectra(algorithm, spatial, k1, prepare_spectra(data.kernel2, spatial))


def _view_weights(weights: torch.Tensor) -> list:
    """Per-view weights for K1: (V,) scalars become Python floats (read back
    once per call), (V, Z, Y, X) stacks stay tensors."""
    if weights.ndim == 1:
        return [float(w) for w in weights.tolist()]
    return list(weights)


def deconvolve(
    psi: torch.Tensor,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
    track_convergence: bool = False,
    prepared: Optional[PreparedSpectra] = None,
):
    """Run ``num_iterations`` RL sweeps over all views; the role of the JAX
    package's ``deconvolve_jit`` as well (PyTorch runs eagerly).

    The caller's ``psi`` is cloned once at entry and never written; the
    clone is then updated in place by K1 every view step (the update is
    elementwise-local).  Tensors run where ``psi`` and ``data`` live.

    ``view_order="sequential"`` reproduces the reference's view-by-view
    update; ``"simultaneous"`` computes every view's update from the same
    psi and blends them additively (psi' = psi + sum_v (new_v - psi)).

    ``adjoint_kernel2=True`` declares kernel2 == flip(kernel1): kernel2
    spectra are the conjugate of kernel1's, applied by K3 without a second
    spectrum stack; data.kernel2 is ignored.  Weights may be (V, Z, Y, X)
    stacks or (V,) scalars.

    ``prepared`` (from :func:`prepare_workspace`) skips the per-call kernel
    forwarding; ``algorithm`` and ``adjoint_kernel2`` were fixed when it was
    made and are ignored here.

    Returns psi, or (psi, deltas) with ``track_convergence``, deltas the
    per-sweep sqrt(mean((psi_i - psi_{i-1})^2)) shaped (num_iterations,).
    """
    spatial = as_shape(psi.shape[-3:])
    if psi.ndim != 3:
        raise ValueError(f"psi must be one (Z, Y, X) volume, got shape {tuple(psi.shape)}")
    if prepared is not None:
        if prepared.spatial != spatial:
            raise ValueError(f"prepared spectra are for {prepared.spatial}, psi is {spatial}")
        engine = prepared.algorithm
        k1, k2, conj_k2 = prepared.k1, prepared.k2, prepared.conj_k2
    else:
        if adjoint_kernel2:
            _check_adjoint(data.kernel1)
        engine = resolve_algorithm(algorithm)
        k1 = prepare_spectra(data.kernel1, spatial)
        if adjoint_kernel2:
            k2, conj_k2 = k1, True
        else:
            k2, conj_k2 = prepare_spectra(data.kernel2, spatial), False
    log.debug("deconvolve: algorithm=%r runs engine %r", algorithm, engine)

    views = data.views
    weights = _view_weights(data.weights)
    num_views = int(views.shape[0])
    psi = psi.clone(memory_format=torch.contiguous_format)

    if view_order == "sequential":

        def sweep(p):
            for v in range(num_views):
                rl_view_step(p, views[v], k1[v], k2[v], weights[v], lam, min_value,
                             conj_k2=conj_k2, out=p)
            return p

    elif view_order == "simultaneous":
        check_simultaneous_weights(data.weights)

        def sweep(p):
            integral = convolve_spectrum(p, k1)
            integral = quotient(views, integral, out=integral)
            integral = convolve_spectrum(integral, k2, conj_k=conj_k2)
            blend = torch.zeros_like(p)
            for v in range(num_views):
                blend += rl_update(p, integral[v], weights[v], lam, min_value) - p
            return p.add_(blend)

    else:
        raise ValueError(f"unknown view_order {view_order!r}")

    if not track_convergence:
        for _ in range(num_iterations):
            psi = sweep(psi)
        return psi
    deltas = []
    for _ in range(num_iterations):
        prev = psi.clone()
        psi = sweep(psi)
        deltas.append(torch.sqrt(torch.mean((psi - prev) ** 2)))
    return psi, torch.stack(deltas) if deltas else psi.new_zeros((0,))


def deconvolve_with_history(
    psi: torch.Tensor,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`deconvolve` but also returns the per-sweep update norms
    ``sqrt(mean((psi_i - psi_{i-1})^2))``, shaped (num_iterations,)."""
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order, algorithm,
        adjoint_kernel2, track_convergence=True,
    )


def deconvolve_prepared(
    psi: torch.Tensor,
    data: MultiViewData,
    prepared: PreparedSpectra,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
) -> torch.Tensor:
    """RL using pre-forwarded spectra (no per-call kernel FFTs): the
    time-lapse serving path, sharing the whole :func:`deconvolve` driver."""
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order, prepared=prepared
    )


def deconvolve_workspace(psi: torch.Tensor, ws: Workspace, **kw):
    """Convenience wrapper taking a :class:`Workspace` (the C-ABI shape)."""
    return deconvolve(
        psi, ws.data, num_iterations=ws.num_iterations, lam=ws.lambda_,
        min_value=ws.min_value, **kw,
    )
