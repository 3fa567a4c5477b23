"""Richardson-Lucy deconvolution drivers (single device): the fft, fused,
dft and direct engines.

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

``algorithm="dft"`` convolves by matrix-product DFTs (:mod:`..core.dft`)
and ``"direct"`` in the spatial domain (:func:`..core.convolve.
direct_convolve3d`); both take the quotient through K2 and the update
through K1, as the fft engine does.

PyTorch runs eagerly: :func:`deconvolve_jit` is :func:`deconvolve` under
the JAX package's name, and λ/min_value are runtime values on every call.
``elementwise`` ("jnp" or "pallas", JAX's choice of update chain) is
accepted by every entry point; both run the port's kernels (:func:`_select_rl_update`).
:func:`resolve_algorithm` says which engine ``"auto"`` runs, for every
caller (in-core, interleaved, streamed and the dispatch ladder), and the
module logger records it at DEBUG.  Under a profiler, a :func:`deconvolve`
call is the span ``lmvn.deconvolve`` and its kernel forwarding
``lmvn.forward`` (:func:`..utils.trace.span`).
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional, Sequence, Tuple

import torch

from ..core.convolve import convolve_spectrum, direct_convolve3d
from ..core.dft import dft3, dft_convolve_spectrum, make_plan
from ..core.fft import rfft3, stack_spectra
from ..core.shapes import as_shape
from ..core.wrap import wrap_kernel
from ..ops.elementwise import quotient, rl_update
from ..ops.fused import (
    _largest_prime_factor,
    check_transposed_shape,
    fused_forward_transposed,
    fused_limit,
    fused_rl_step_carried,
    fused_rl_step_transposed,
    kernel_spectrum_fused,
)
from ..utils.trace import spanned
from .workspace import MultiViewData, Workspace, check_simultaneous_weights

log = logging.getLogger(__name__)

ENGINES = ("fft", "dft", "fused", "direct")


def _select_rl_update(elementwise: str):
    """The update of an ``elementwise`` request: JAX's ``"jnp"`` (XLA's
    fused chain) and ``"pallas"`` (its explicit kernel) both run the port's
    K1 (:func:`..ops.elementwise.rl_update`); any other value raises
    ``ValueError``, as in JAX (``rl.py:50-67``)."""
    if elementwise in ("jnp", "pallas"):
        return rl_update
    raise ValueError(f"unknown elementwise {elementwise!r}")


def _apply_update(update_fn, psi, integral, weights, lam, min_value, out):
    """``update_fn``'s result, written to ``out`` when one is given; K1
    writes it there itself."""
    if update_fn is rl_update:
        return rl_update(psi, integral, weights, lam, min_value, out=out)
    res = update_fn(psi, integral, weights, lam, min_value)
    return res if out is None else out.copy_(res)


def _auto_device(device) -> torch.device:
    """The device an ``"auto"`` request is resolved for: ``device``, or the
    card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def resolve_algorithm(algorithm: str, spatial_shape, device=None, chunk: bool = False) -> str:
    """The engine a request runs on ``device`` (default: the card when there
    is one) for a (Z, Y, X) ``spatial_shape``; ``chunk`` marks a streamed
    rung's halo-extended chunk or a batch of volumes, neither of which takes
    the fused engine.

    On the CPU, ``"auto"`` is the JAX package's rule on a CPU backend: dft
    up to 256 per axis, fft above, never fused.  On a CUDA device it is
    :func:`_cuda_auto`, the table measured on the H100: past Z = 736 or
    X = 1816 fused only in the classes timed against fft there
    (:func:`_fused_timed`; fft / fused 5.226 / 6.144 it/s at (256, 1024,
    2048), 10.156 / 13.765 at (1024, 512, 512), NVIDIA H100 80GB HBM3 at
    700 W).  Other names are returned as they are, or raise ``ValueError``
    when unknown."""
    if algorithm != "auto":
        if algorithm not in ENGINES:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        return algorithm
    spatial = tuple(int(s) for s in spatial_shape[-3:])
    dev = _auto_device(device)
    if dev.type != "cuda":
        return "dft" if max(spatial) <= 256 else "fft"
    return _cuda_auto(spatial, dev, chunk)


def _cuda_auto(spatial, device: torch.device, chunk: bool) -> str:
    """``"auto"`` on a CUDA device, the table ``chip_smoke.py`` phase 22
    measured on an NVIDIA H100 (``PERF.md`` §6): the fused engine where
    every axis is at least 256, :func:`fused_eligible` holds and the shape
    is of a class timed against fft (:func:`_fused_timed`), else fft.

    It departs from the JAX package's rule (``rl.py:355-368``) in two rows,
    each beyond the turn-to-turn spread: below 256 per axis fft beat dft by
    3.6-3.9x (JAX picks dft), and at (32, 512, 512) by 1.18x over fused (JAX
    picks fused: its rule looks at the longest axis).  dft lost every row,
    so ``"auto"`` never picks it here; a streamed chunk takes fft."""
    if not chunk and min(spatial) >= 256 and fused_eligible(spatial, device):
        if _fused_timed(spatial):
            return "fused"
    return "fft"


def _fused_timed(spatial) -> bool:
    """Whether a fused-eligible (Z, Y, X) shape is of a class where fused
    was timed against fft.

    Up to Z = 736, Y = 3632 and X = 1816 the FFT stages run their widest
    tiles (16 or 8 sequences), and fused beat fft at every row of 256 per
    axis and up.  Past those lengths two rows were timed, 4 views, 10
    iterations, NVIDIA H100 80GB HBM3 at 700 W, fft / fused in turns:
    (256, 1024, 2048), x tile 8, 5.226 / 6.144 it/s (fused 1.18x, spread
    1.0 %), and (1024, 512, 512), z tile 16, 10.156 / 13.765 (1.36x, spread
    0.1 %).  So fused is kept there only where those rows vouch for it:
    X and Y up to 3632, Z up to 1816 (the tiles of 8 and 16 timed), and
    every length a product of 2, 3, 5 and 7 (no generic radix stage).
    Narrower tiles and generic radices there were never timed end to end
    against fft, and take fft as they did before fused served them; so do
    the long axes past 14528 or with a prime factor over 1024, which the
    fused passes serve through HBM (four-step, Bluestein) up to 2^25."""
    Z, Y, X = spatial
    if Z <= 736 and Y <= 3632 and X <= 1816:
        return True
    if Z > 1816 or Y > 3632 or X > 3632:
        return False
    return all(_largest_prime_factor(n) <= 7 for n in spatial)


def fused_eligible(spatial_shape, device=None) -> bool:
    """Whether ``algorithm="fused"`` can serve this (Z, Y, X) shape on
    ``device`` (:func:`..ops.fused.fused_limit`): every axis a multiple of 8,
    and on a CUDA device each axis at most 2^25, the kernels' limit."""
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


def prepare_spectra_split(kernels: torch.Tensor, spatial_shape: Sequence[int]):
    """The (re, im) pair of a (V, kz, ky, kx) kernel stack's spectra in the
    :func:`..core.dft.dft3` layout (JAX ``rl.py:261-268``)."""
    spatial = as_shape(spatial_shape)
    wrapped = torch.stack([wrap_kernel(k.to(torch.float32), spatial) for k in kernels])
    return dft3(wrapped, make_plan(spatial, kernels.device))


def rl_view_step_fused(
    psi: torch.Tensor,
    view: torch.Tensor,
    k1_split,
    k2_split,
    weights,
    lam,
    min_value: float,
    update_fn=None,
    conj_k2: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One view's update through the fused engine (K4, K6, K8, K6, K9), in
    the (Z, X, Y) transposed domain: psi, view and per-voxel weights
    transposed, kernel spectra as fused (Kxp, Z, Y) (re, im) pairs.  The
    update runs inside the last pass, so ``update_fn`` is ignored, as in
    JAX."""
    del update_fn
    return fused_rl_step_transposed(psi, view, k1_split, k2_split, weights, lam, min_value,
                                    conj_k2=conj_k2, out=out)


def rl_view_step(
    psi: torch.Tensor,
    view: torch.Tensor,
    k1_hat: torch.Tensor,
    k2_hat: torch.Tensor,
    weights,
    lam,
    min_value: float,
    update_fn=rl_update,
    conj_k2: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One view's multiplicative update (``src/multiviewnative.cpp:191-228``).

    ``update_fn`` takes (psi, integral, weights, lam, min_value), K1 by
    default.  ``conj_k2`` multiplies by conj(k2_hat) (the adjoint of kernel1 when
    k2_hat is kernel1's spectrum).  ``out=psi`` updates psi in place, except
    when grad mode is on and an operand requires grad: then the step builds
    an autograd graph through K1-K3 and returns a new tensor.
    """
    integral = convolve_spectrum(psi, k1_hat)
    integral = quotient(view, integral, out=integral)
    integral = convolve_spectrum(integral, k2_hat, conj_k=conj_k2)
    return _apply_update(update_fn, psi, integral, weights, lam, min_value, out)


def rl_view_step_dft(
    psi: torch.Tensor,
    view: torch.Tensor,
    k1_split: Tuple[torch.Tensor, torch.Tensor],
    k2_split: Tuple[torch.Tensor, torch.Tensor],
    weights,
    lam,
    min_value: float,
    update_fn=rl_update,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The view step with the matmul-DFT engine (:mod:`..core.dft`): the
    kernel spectra are (re, im) pairs in the dft3 layout."""
    integral = dft_convolve_spectrum(psi, *k1_split)
    integral = quotient(view, integral, out=integral)
    integral = dft_convolve_spectrum(integral, *k2_split)
    return _apply_update(update_fn, psi, integral, weights, lam, min_value, out)


def rl_view_step_direct(
    psi: torch.Tensor,
    view: torch.Tensor,
    kernel1: torch.Tensor,
    kernel2: torch.Tensor,
    weights,
    lam,
    min_value: float,
    update_fn=rl_update,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The view step with the direct engine: both convolves circular in the
    spatial domain (:func:`..core.convolve.direct_convolve3d`), the kernels
    as they are."""
    integral = direct_convolve3d(psi, kernel1, mode="circular")
    integral = quotient(view, integral, out=integral)
    integral = direct_convolve3d(integral, kernel2, mode="circular")
    return _apply_update(update_fn, psi, integral, weights, lam, min_value, out)


class PreparedSpectra:
    """Pre-forwarded kernel spectra bound to an (algorithm, shape) pair: the
    serving-path plan store.  ``conj_k2`` marks ``k2`` as kernel1's spectrum,
    to be conjugated on the fly (``adjoint_kernel2``).  The fused and dft
    engines' spectra are (re, im) pairs; ``xmode`` tags the fused spectra's
    x-row layout (see :data:`FUSED_XMODE`), None for the other engines."""

    def __init__(self, algorithm: str, spatial, k1, k2, conj_k2: bool = False,
                 xmode: Optional[str] = None):
        self.algorithm = algorithm
        self.spatial = as_shape(spatial)
        self.k1 = k1
        self.k2 = k2
        self.conj_k2 = bool(conj_k2)
        self.xmode = xmode


# a module attribute that deconvolve calls through the module's globals, so
# that a caller can wrap it from outside (the benchmark's forwarding range)
@spanned("lmvn.forward")
def _forward_spectra(engine: str, data: MultiViewData, spatial, adjoint_kernel2: bool):
    """(k1, k2, conj_k2) of an engine: complex spectra for fft, (re, im)
    pairs for fused and dft, the kernels themselves for direct.  With the
    adjoint, fft and fused conjugate k1 on the fly (k2 is k1); dft takes k1
    with its imaginary part negated, and direct the flipped kernel1, as the
    JAX package does."""
    if engine == "direct":
        k2 = torch.flip(data.kernel1, dims=(-3, -2, -1)) if adjoint_kernel2 else data.kernel2
        return data.kernel1, k2, False
    if engine == "dft":
        k1 = prepare_spectra_split(data.kernel1, spatial)
        if adjoint_kernel2:
            return k1, (k1[0], -k1[1]), False
        return k1, prepare_spectra_split(data.kernel2, spatial), False
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
    ``"auto"`` resolves as :func:`deconvolve` would.  The direct engine has
    no spectra to prepare and is refused (ValueError), as in JAX."""
    spatial = as_shape(spatial_shape)
    if adjoint_kernel2:
        _check_adjoint(data.kernel1)
    algorithm = resolve_algorithm(algorithm, spatial, data.views.device)
    if algorithm == "direct":
        raise ValueError(f"prepare_workspace supports fft/dft/fused, not {algorithm!r}")
    k1, k2, conj_k2 = _forward_spectra(algorithm, data, spatial, adjoint_kernel2)
    xmode = FUSED_XMODE if algorithm == "fused" else None
    return PreparedSpectra(algorithm, spatial, k1, k2, conj_k2=conj_k2, xmode=xmode)


def _blend(p: torch.Tensor, blend: torch.Tensor) -> torch.Tensor:
    """p + blend, in place unless autograd records it (K1 saved p)."""
    return p + blend if blend.requires_grad else p.add_(blend)


def _view_weights(weights: torch.Tensor) -> list:
    """Per-view weights for K1: (V,) scalars become Python floats (read back
    once per call) unless autograd must see them, then 0-dim tensors;
    (V, Z, Y, X) and (V, *B, Z, Y, X) stacks stay tensors, one per view."""
    if weights.ndim == 1 and not (weights.requires_grad and torch.is_grad_enabled()):
        return [float(w) for w in weights.tolist()]
    return list(weights)


@spanned("lmvn.deconvolve")
def deconvolve(
    psi: torch.Tensor,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
    elementwise: str = "jnp",
    track_convergence: bool = False,
    prepared: Optional[PreparedSpectra] = None,
):
    """Run ``num_iterations`` RL sweeps over all views; the role of the JAX
    package's ``deconvolve_jit`` as well (PyTorch runs eagerly).

    The caller's ``psi`` is copied once at entry and never written; the copy
    is then updated in place every view step (the update is
    elementwise-local).  Tensors run where ``psi`` and ``data`` live.

    ``algorithm``: ``"fft"`` (cuFFT and K1-K3), ``"fused"`` (the five-pass
    fused engine, K4/K6/K8/K9, shapes :func:`fused_eligible` accepts),
    ``"dft"`` (matrix-product DFTs, K1 and K2), ``"direct"`` (spatial
    convolves, K1 and K2) or ``"auto"`` (:func:`resolve_algorithm` on psi's
    device).  The fused engine works in the (Z, X, Y) transposed domain:
    views, per-voxel weights and psi are transposed once here, outside the
    iterations, and psi back at the end.

    ``view_order="sequential"`` reproduces the reference's view-by-view
    update; ``"simultaneous"`` computes every view's update from the same
    psi and blends them additively (psi' = psi + sum_v (new_v - psi)).
    On the fused engine, the sequential order runs the carried chain when
    :func:`_carry_enabled` says so (``LMVN_FUSED_CARRY=1``).

    ``adjoint_kernel2=True`` declares kernel2 == flip(kernel1): kernel2
    spectra are the conjugate of kernel1's, applied on the fly (K3 or K6)
    without a second spectrum stack on the fft and fused engines, with a
    negated imaginary part on dft and as the flipped kernel1 on direct;
    data.kernel2 is ignored.  Weights may be (V, Z, Y, X) stacks or (V,)
    scalars.

    ``elementwise``: ``"jnp"`` or ``"pallas"``, both K1 here
    (:func:`_select_rl_update`); another value raises ``ValueError``.

    ``prepared`` (from :func:`prepare_workspace`) skips the per-call kernel
    forwarding; ``algorithm`` and ``adjoint_kernel2`` were fixed when it was
    made and are ignored here.

    The fused engine stores its spectra as :func:`..ops.fused.spec_dtype`
    says, read by each pass: float32, or bfloat16 with
    ``LMVN_FUSED_SPEC_BF16=1`` (opt-in, outside the fp32 contract).  Fused
    spectra prepared under the other setting are read as they are, widened
    where a pass reads them, as in JAX.

    Batches, as in the JAX package: psi may be (*B, Z, Y, X), one problem
    per leading entry, and the result has psi's shape, entry b equal to the
    call on entry b.  Views are (V, Z, Y, X), shared by the batch, or
    (V, *B, Z, Y, X); weights (V,), (V, Z, Y, X) or (V, *B, Z, Y, X).  K1
    and K2 read a shared view or weight volume once for the whole batch,
    and K3 applies each spectrum to the batch, so a sweep launches each as
    often as for one volume.  The fused engine takes one volume:
    ``algorithm="fused"`` with a batched psi raises ``ValueError``, and
    ``"auto"`` never picks it for one.

    Gradients: with grad mode on, the fft, dft and direct engines are
    differentiable in psi, a 0-dim tensor ``lam`` and ``data.weights``
    (through K1-K3's autograd functions); the fused engine raises for an
    operand that requires grad.

    Returns psi, or (psi, deltas) with ``track_convergence``, deltas the
    per-sweep sqrt(mean((psi_i - psi_{i-1})^2)) over the whole batch,
    shaped (num_iterations,).
    """
    _select_rl_update(elementwise)
    spatial = as_shape(psi.shape[-3:])
    if psi.ndim < 3:
        raise ValueError(f"psi must be (*B, Z, Y, X), got shape {tuple(psi.shape)}")
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
        # a batch, like a streamed chunk, never takes the fused engine
        engine = resolve_algorithm(algorithm, spatial, psi.device, chunk=psi.ndim != 3)
    if engine == "fused" and psi.ndim != 3:
        raise ValueError("algorithm='fused' operates on single volumes")
    if prepared is None:
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
        step = functools.partial(rl_view_step_fused, conj_k2=conj_k2)
    else:
        psi = psi.clone(memory_format=torch.contiguous_format)
        step = {
            "fft": functools.partial(rl_view_step, conj_k2=conj_k2),
            "dft": rl_view_step_dft,
            "direct": rl_view_step_direct,
        }[engine]
    if engine in ("fused", "dft"):
        k1, k2 = list(zip(*k1)), list(zip(*k2))  # one (re, im) pair per view

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
                p = step(p, views[v], k1[v], k2[v], weights[v], lam, min_value, out=p)
            return p

    elif view_order == "simultaneous":
        check_simultaneous_weights(data.weights)

        def sweep(p):
            blend = torch.zeros_like(p)
            if engine != "fft" or p.ndim != 3:
                # a batched psi meets the views one at a time: K3 applies
                # each view's spectrum to the whole batch, 2V launches
                for v in range(num_views):
                    blend += step(p, views[v], k1[v], k2[v], weights[v], lam, min_value) - p
                return _blend(p, blend)
            integral = convolve_spectrum(p, k1)
            integral = quotient(views, integral, out=integral)
            integral = convolve_spectrum(integral, k2, conj_k=conj_k2)
            for v in range(num_views):
                blend += rl_update(p, integral[v], weights[v], lam, min_value) - p
            return _blend(p, blend)

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


def deconvolve_jit(
    psi: torch.Tensor,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
    elementwise: str = "jnp",
) -> torch.Tensor:
    """:func:`deconvolve` under the JAX package's name and signature, with
    its default ``algorithm="fft"``.  PyTorch runs eagerly, so nothing is
    compiled; and unlike JAX's, which donates psi, the caller's psi is
    never written."""
    return deconvolve(psi, data, num_iterations, lam, min_value, view_order, algorithm,
                      adjoint_kernel2, elementwise)


def deconvolve_prepared(
    psi: torch.Tensor,
    data: MultiViewData,
    prepared: PreparedSpectra,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    elementwise: str = "jnp",
) -> torch.Tensor:
    """RL using pre-forwarded spectra (no per-call kernel FFTs): the
    time-lapse serving path, sharing the whole :func:`deconvolve` driver."""
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order, elementwise=elementwise,
        prepared=prepared,
    )


def deconvolve_workspace(psi: torch.Tensor, ws: Workspace, **kw):
    """Convenience wrapper taking a :class:`Workspace` (the C-ABI shape)."""
    return deconvolve(
        psi, ws.data, num_iterations=ws.num_iterations, lam=ws.lambda_,
        min_value=ws.min_value, **kw,
    )
