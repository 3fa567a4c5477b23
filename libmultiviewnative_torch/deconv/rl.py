"""Richardson-Lucy deconvolution drivers (single device): the fft and fused
engines.

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

``algorithm="fused"`` runs the fused engine of :mod:`..ops.fused` instead:
five passes per view step (K4, K6, K8, K6, K9) on (Z, X, Y)-transposed
volumes, with the kernel spectra forwarded by the same passes (K4, and K5
where the kernel is long in z).  The driver transposes views, weights and
psi once per call, outside the iterations.  ``LMVN_FUSED_CARRY=1`` runs the
sequential order as the carried chain instead: four passes per view step
(K6, K8, K6, K10), pass A of psi carried from one step to the next and
seeded once per call (:func:`_carry_enabled`).

PyTorch runs eagerly, so there is no ``deconvolve_jit``: :func:`deconvolve`
takes its role, and λ/min_value are runtime values on every call.

Engines: ``"fft"`` and ``"fused"``.  ``"auto"`` resolves to ``"fft"``: which
engine it should pick is for an H100 measurement to decide (ROADMAP slice 3).
:func:`resolve_algorithm` says what a request runs, and the module logger
records it at DEBUG.  ``"dft"`` and ``"direct"`` raise
:class:`NotImplementedError`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import torch

from ..core.convolve import convolve_spectrum
from ..core.fft import rfft3, stack_spectra
from ..core.shapes import as_shape
from ..core.wrap import wrap_kernel
from ..ops.elementwise import quotient, rl_update
from ..ops.fused import (
    check_transposed_shape,
    fused_forward_transposed,
    fused_limit,
    fused_rl_step_carried,
    fused_rl_step_transposed,
    kernel_spectrum_fused,
)
from .workspace import MultiViewData, Workspace, check_simultaneous_weights

log = logging.getLogger(__name__)

_NOT_PORTED = {
    "dft": "the matmul-DFT engine is not ported yet (ROADMAP P8)",
    "direct": "the direct stencil engine is not ported yet (ROADMAP P4, direct_convolve3d)",
}


def resolve_algorithm(algorithm: str) -> str:
    """The engine a request runs: ``"auto"`` means ``"fft"`` in the port
    until an H100 measurement decides otherwise; unported engines raise."""
    if algorithm == "auto":
        algorithm = "fft"
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(f"algorithm={algorithm!r}: {_NOT_PORTED[algorithm]}")
    if algorithm not in ("fft", "fused"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return algorithm


def fused_eligible(spatial_shape, device=None) -> bool:
    """Whether ``algorithm="fused"`` can serve this (Z, Y, X) shape on
    ``device`` (:func:`..ops.fused.fused_limit`): every axis a multiple of 8,
    and on a CUDA device within the kernels' limits."""
    Z, Y, X = (int(s) for s in spatial_shape[-3:])
    return fused_limit((Z, X, Y), device) is None


def _carry_enabled() -> bool:
    """Whether the fused engine's sequential order runs the carried chain
    (``fused_rl_step_carried``, K10) in place of the plain one: the JAX
    package's choice at its fp32 ``"highest"`` precision (``rl.py:156-204``).
    ``LMVN_FUSED_CARRY=1`` selects it; ``0``, unset or any other value gives
    the plain chain, which is the JAX default at that precision.  Read on
    each :func:`deconvolve` call.  Both chains give the same values."""
    return os.environ.get("LMVN_FUSED_CARRY") == "1"


# The x-row layout of fused spectra.  The port has one x mode, the dense
# packed one, whose spectra are in the natural hermitian row order (the JAX
# package's split-x mode, 'splitx', is not ported).
FUSED_XMODE = "standard"


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


def prepare_spectra_fused(kernels: torch.Tensor, spatial_shape: Sequence[int]):
    """The (V, Kxp, Z, Y) re/im pair of a (V, kz, ky, kx) kernel stack's
    fused spectra, forwarded one view at a time."""
    spatial = as_shape(spatial_shape)
    outs = [kernel_spectrum_fused(k, spatial) for k in kernels]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


# One view's update through the fused engine, in the (Z, X, Y) transposed
# domain, with rl_view_step's arguments: psi, view and per-voxel weights
# transposed, kernel spectra as fused (Kxp, Z, Y) (re, im) pairs.
rl_view_step_fused = fused_rl_step_transposed


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
    k2_hat is kernel1's spectrum).  ``out=psi`` updates psi in place, except
    when grad mode is on and an operand requires grad: then the step builds
    an autograd graph through K1-K3 and returns a new tensor.
    """
    integral = convolve_spectrum(psi, k1_hat)
    integral = quotient(view, integral, out=integral)
    integral = convolve_spectrum(integral, k2_hat, conj_k=conj_k2)
    return rl_update(psi, integral, weights, lam, min_value, out=out)


class PreparedSpectra:
    """Pre-forwarded kernel spectra bound to an (algorithm, shape) pair: the
    serving-path plan store.  ``conj_k2`` marks ``k2`` as kernel1's spectrum,
    to be conjugated on the fly (``adjoint_kernel2``).  The fused engine's
    spectra are (re, im) pairs, and ``xmode`` tags their x-row layout (see
    :data:`FUSED_XMODE`); None for the fft engine."""

    def __init__(self, algorithm: str, spatial, k1, k2, conj_k2: bool = False,
                 xmode: Optional[str] = None):
        self.algorithm = algorithm
        self.spatial = as_shape(spatial)
        self.k1 = k1
        self.k2 = k2
        self.conj_k2 = bool(conj_k2)
        self.xmode = xmode


def _forward_spectra(engine: str, data: MultiViewData, spatial, adjoint_kernel2: bool):
    """(k1, k2, conj_k2) of an engine: complex spectra for fft, (re, im)
    pairs for fused.  With the adjoint, k2 is k1, conjugated on the fly."""
    if engine == "fused":
        check_transposed_shape((spatial[0], spatial[2], spatial[1]), data.views.device)
        prepare = prepare_spectra_fused
    else:
        prepare = prepare_spectra
    k1 = prepare(data.kernel1, spatial)
    if adjoint_kernel2:
        return k1, k1, True
    return k1, prepare(data.kernel2, spatial), False


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
    k1, k2, conj_k2 = _forward_spectra(algorithm, data, spatial, adjoint_kernel2)
    xmode = FUSED_XMODE if algorithm == "fused" else None
    return PreparedSpectra(algorithm, spatial, k1, k2, conj_k2=conj_k2, xmode=xmode)


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

    The caller's ``psi`` is copied once at entry and never written; the copy
    is then updated in place every view step (the update is
    elementwise-local).  Tensors run where ``psi`` and ``data`` live.

    ``algorithm``: ``"fft"`` (cuFFT and K1-K3), ``"fused"`` (the five-pass
    fused engine, K4/K6/K8/K9, shapes :func:`fused_eligible` accepts) or
    ``"auto"``, which means ``"fft"``.  The fused engine works in the
    (Z, X, Y) transposed domain: views, per-voxel weights and psi are
    transposed once here, outside the iterations, and psi back at the end.

    ``view_order="sequential"`` reproduces the reference's view-by-view
    update; ``"simultaneous"`` computes every view's update from the same
    psi and blends them additively (psi' = psi + sum_v (new_v - psi)).
    On the fused engine, the sequential order runs the carried chain when
    :func:`_carry_enabled` says so (``LMVN_FUSED_CARRY=1``).

    ``adjoint_kernel2=True`` declares kernel2 == flip(kernel1): kernel2
    spectra are the conjugate of kernel1's, applied on the fly (K3 or K6)
    without a second spectrum stack; data.kernel2 is ignored.  Weights may
    be (V, Z, Y, X) stacks or (V,) scalars.

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
        if engine == "fused" and prepared.xmode != FUSED_XMODE:
            raise ValueError(
                f"prepared fused spectra are in the {prepared.xmode!r} x-row layout, but "
                f"this engine reads the {FUSED_XMODE!r} one: re-prepare the workspace"
            )
        k1, k2, conj_k2 = prepared.k1, prepared.k2, prepared.conj_k2
    else:
        if adjoint_kernel2:
            _check_adjoint(data.kernel1)
        engine = resolve_algorithm(algorithm)
        k1, k2, conj_k2 = _forward_spectra(engine, data, spatial, adjoint_kernel2)
    log.debug("deconvolve: algorithm=%r runs engine %r", algorithm, engine)

    views = data.views
    weights = _view_weights(data.weights)
    num_views = int(views.shape[0])
    fused = engine == "fused"
    if fused:
        # the whole loop lives in the fused passes' (Z, X, Y) domain; the
        # RL steps are layout-agnostic, so these are the only transposes
        views = views.transpose(-1, -2).contiguous()
        if data.weights.ndim > 1:
            weights = list(data.weights.transpose(-1, -2).contiguous())
        psi = psi.transpose(-1, -2).contiguous()
        k1 = list(zip(*k1))
        k2 = list(zip(*k2))
        step = rl_view_step_fused
    else:
        psi = psi.clone(memory_format=torch.contiguous_format)
        step = rl_view_step

    carried = fused and view_order == "sequential" and _carry_enabled()
    log.debug("deconvolve: carried fused chain %s", carried)
    if carried:

        def sweep(c):
            p, u = c
            for v in range(num_views):
                p, u = fused_rl_step_carried(p, u, views[v], k1[v], k2[v], weights[v], lam,
                                             min_value, conj_k2=conj_k2, out=p)
            return p, u

    elif view_order == "sequential":

        def sweep(p):
            for v in range(num_views):
                # p itself unless autograd records the step (then a new tensor)
                p = step(p, views[v], k1[v], k2[v], weights[v], lam, min_value,
                         conj_k2=conj_k2, out=p)
            return p

    elif view_order == "simultaneous":
        check_simultaneous_weights(data.weights)

        def sweep(p):
            blend = torch.zeros_like(p)
            if fused:
                for v in range(num_views):
                    blend += step(p, views[v], k1[v], k2[v], weights[v], lam, min_value,
                                  conj_k2=conj_k2) - p
                return p.add_(blend)
            integral = convolve_spectrum(p, k1)
            integral = quotient(views, integral, out=integral)
            integral = convolve_spectrum(integral, k2, conj_k=conj_k2)
            for v in range(num_views):
                blend += rl_update(p, integral[v], weights[v], lam, min_value) - p
            return p.add_(blend)

    else:
        raise ValueError(f"unknown view_order {view_order!r}")

    untranspose = (lambda p: p.transpose(-1, -2).contiguous()) if fused else (lambda p: p)
    # the carried chain's state is (psi, pass A of psi); deltas are on psi
    state = (psi, fused_forward_transposed(psi)) if carried else psi
    get_psi = (lambda c: c[0]) if carried else (lambda c: c)
    if not track_convergence:
        for _ in range(num_iterations):
            state = sweep(state)
        return untranspose(get_psi(state))
    deltas = []
    for _ in range(num_iterations):
        prev = get_psi(state).clone()
        state = sweep(state)
        deltas.append(torch.sqrt(torch.mean((get_psi(state) - prev) ** 2)))
    psi = get_psi(state)
    return untranspose(psi), torch.stack(deltas) if deltas else psi.new_zeros((0,))


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
