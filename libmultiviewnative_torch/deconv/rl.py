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
psi once per call, outside the iterations; a batch runs one entry at a
time, its per-entry operands transposed as each entry comes.
``LMVN_FUSED_CARRY=1`` runs the sequential order as the carried chain
instead: four passes per view step (K6, K8, K6, K10), pass A of psi
carried from one step to the next and seeded once per entry
(:func:`_carry_enabled`).

``algorithm="dft"`` convolves by matrix-product DFTs (:mod:`..core.dft`)
and ``"direct"`` in the spatial domain (:func:`..core.convolve.
direct_convolve3d`); both take the quotient through K2 and the update
through K1, as the fft engine does.

PyTorch runs eagerly: :func:`deconvolve_jit` is :func:`deconvolve` under
the JAX package's name, and λ/min_value are runtime values on every call.
``elementwise`` ("jnp" or "pallas", JAX's choice of update chain) is
accepted by every entry point; both run the port's kernels.  The engine
table (:mod:`.engines`) forwards the kernels and resolves ``"auto"`` for
every caller; the module logger records the engine at DEBUG.  Under a
profiler, a :func:`deconvolve` call is the span ``lmvn.deconvolve`` and its
kernel forwarding ``lmvn.forward`` (:func:`..utils.trace.span`).
"""

from __future__ import annotations

import functools
import logging
import math
import os
from typing import Optional, Tuple

import torch

from ..core.convolve import convolve_spectrum, direct_convolve3d
from ..core.dft import dft_convolve_spectrum
from ..core.shapes import as_shape
from ..ops.elementwise import quotient, rl_update
from ..ops.fused import fused_forward_transposed, fused_rl_step_carried, fused_rl_step_transposed
from ..utils.trace import spanned, trace_print
from .engines import (  # noqa: F401 (the engine table's names, re-exported where JAX has them)
    apply_update,
    check_adjoint,
    forward,
    fused_eligible,
    prepare_spectra,
    prepare_spectra_fused,
    prepare_spectra_split,
    resolve_algorithm,
    select_update,
)
from .workspace import MultiViewData, Workspace, check_simultaneous_weights

log = logging.getLogger(__name__)

# the JAX package's private name of :func:`.engines.select_update`
_select_rl_update = select_update


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
    return apply_update(update_fn, psi, integral, weights, lam, min_value, out)


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
    return apply_update(update_fn, psi, integral, weights, lam, min_value, out)


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
    return apply_update(update_fn, psi, integral, weights, lam, min_value, out)


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
    """(k1, k2, conj_k2) of an engine, each kernel stack forwarded whole
    (:func:`.engines.forward`)."""
    return forward(engine, data.kernel1, data.kernel2, spatial, data.views.device,
                   adjoint_kernel2)


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
        check_adjoint(data.kernel1)
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

    ``adjoint_kernel2=True`` declares kernel2 == flip(kernel1) and ignores
    data.kernel2: each engine has kernel2's operand from kernel1's
    (:data:`.engines.TABLE`).  Weights may be (V, Z, Y, X) stacks or (V,)
    scalars.

    ``elementwise``: ``"jnp"`` or ``"pallas"``, both K1 here
    (:func:`.engines.select_update`); another value raises ``ValueError``.

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
    often as for one volume.  The fused engine, whose passes take one
    volume, runs the entries one at a time (:func:`_deconvolve_fused`): the
    kernel spectra are forwarded once for the call and shared views and
    weights transposed once, and entry b equals, bitwise, the single-volume
    fused call on it.  ``"auto"`` gives a batch the engine it gives one of
    its volumes.  JAX's fused engine refuses a batch.

    Gradients: with grad mode on, the fft, dft and direct engines are
    differentiable in psi, a 0-dim tensor ``lam`` and ``data.weights``
    (through K1-K3's autograd functions); the fused engine raises for an
    operand that requires grad.

    Returns psi, or (psi, deltas) with ``track_convergence``, deltas the
    per-sweep sqrt(mean((psi_i - psi_{i-1})^2)) over the whole batch,
    shaped (num_iterations,).
    """
    select_update(elementwise)
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
            check_adjoint(data.kernel1)
        # a batch resolves as one of its volumes
        engine = resolve_algorithm(algorithm, spatial, psi.device)
        k1, k2, conj_k2 = _forward_spectra(engine, data, spatial, adjoint_kernel2)
    log.debug("deconvolve: algorithm=%r runs engine %r", algorithm, engine)
    if view_order == "simultaneous":
        check_simultaneous_weights(data.weights)
    elif view_order != "sequential":
        raise ValueError(f"unknown view_order {view_order!r}")
    if engine in ("fused", "dft"):
        k1, k2 = list(zip(*k1)), list(zip(*k2))  # one (re, im) pair per view
    if engine == "fused":
        return _deconvolve_fused(psi, data, k1, k2, conj_k2, num_iterations, lam, min_value,
                                 view_order, track_convergence)

    step = {
        "fft": functools.partial(rl_view_step, conj_k2=conj_k2),
        "dft": rl_view_step_dft,
        "direct": rl_view_step_direct,
    }[engine]
    psi = psi.clone(memory_format=torch.contiguous_format)
    sweep = _sweep(step, data.views, _view_weights(data.weights), k1, k2, lam, min_value,
                   view_order, stacked=engine == "fft" and psi.ndim == 3, conj_k2=conj_k2)
    psi, msq = _iterate(psi, sweep, num_iterations, track_convergence)
    return (psi, _deltas([msq], psi)) if track_convergence else psi


def _sweep(step, views, weights, k1, k2, lam, min_value, view_order, carried=False,
           stacked=False, conj_k2=False):
    """One RL sweep over the views of one problem: sequential, carried on
    the fused engine (its state the pair (psi, pass A of psi)), or
    simultaneous.  ``stacked`` marks the fft engine's single volume, whose
    simultaneous sweep convolves every view at once with the stacked
    spectra ``k1`` and ``k2``."""
    num_views = int(views.shape[0])
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

    elif not stacked:

        def sweep(p):
            # a batched psi meets the views one at a time: K3 applies each
            # view's spectrum to the whole batch, 2V launches
            blend = torch.zeros_like(p)
            for v in range(num_views):
                blend += step(p, views[v], k1[v], k2[v], weights[v], lam, min_value) - p
            return _blend(p, blend)

    else:

        def sweep(p):
            blend = torch.zeros_like(p)
            integral = convolve_spectrum(p, k1)
            integral = quotient(views, integral, out=integral)
            integral = convolve_spectrum(integral, k2, conj_k=conj_k2)
            for v in range(num_views):
                blend += rl_update(p, integral[v], weights[v], lam, min_value) - p
            return _blend(p, blend)

    return sweep


def _iterate(state, sweep, num_iterations: int, track: bool, carried: bool = False):
    """psi after ``num_iterations`` sweeps from ``state``, and with
    ``track`` the mean square of each sweep's change of psi (else [])."""
    get_psi = (lambda c: c[0]) if carried else (lambda c: c)
    msq = []
    for _ in range(num_iterations):
        prev = get_psi(state).clone() if track else None
        state = sweep(state)
        if track:
            msq.append(torch.mean((get_psi(state) - prev) ** 2))
    return get_psi(state), msq


def _deltas(msqs: list, like: torch.Tensor) -> torch.Tensor:
    """The per-sweep sqrt(mean((psi_i - psi_{i-1})^2)) over a batch from
    each entry's (or the whole batch's) mean squares: the entries are of
    one size, so the batch's mean is the mean of theirs."""
    if not msqs or not msqs[0]:
        return like.new_zeros((0,))
    return torch.sqrt(torch.stack([torch.stack(m) for m in msqs]).mean(0))


def working_volumes(engine: str, batch: int = 1) -> int:
    """The f32 volumes of psi and its temporaries :func:`deconvolve` holds
    for a psi of ``batch`` volumes: about 8 a volume, or on the fused engine,
    one entry at a time (:func:`_deconvolve_fused`), one entry's 8 and the
    input and output of each further entry."""
    return 8 + 2 * (batch - 1) if engine == "fused" else 8 * batch


def _deconvolve_fused(psi, data, k1, k2, conj_k2, num_iterations, lam, min_value, view_order,
                      track):
    """:func:`deconvolve` on the fused engine, one entry of psi (*B, Z, Y,
    X) at a time: each entry runs the sweeps of a single-volume call in the
    passes' (Z, X, Y) domain, with the kernel spectra forwarded once for
    the call.  A single volume is a batch of one.  Views and weights shared
    by the batch are transposed once per call, a (V, *B, Z, Y, X) operand
    one entry at a time, so that one entry's transposed operands are held
    at a time."""
    spatial = tuple(psi.shape[-3:])
    batch = tuple(psi.shape[:-3])
    nb = math.prod(batch)

    def transposed(x):
        return x.transpose(-1, -2).contiguous()

    def per_entry(x):
        """(V, nb, Z, Y, X) of a batched operand; None for a shared one."""
        if x.ndim <= 4:
            return None
        if tuple(x.shape[1:-3]) != batch:
            raise ValueError(f"views and weights (V, *B, Z, Y, X) need B = {batch}, got "
                             f"{tuple(x.shape)}")
        return x.reshape((x.shape[0], nb) + spatial)

    views_b, weights_b = per_entry(data.views), per_entry(data.weights)
    views = transposed(data.views) if views_b is None else None
    if data.weights.ndim == 1:
        weights = _view_weights(data.weights)
    else:
        weights = list(transposed(data.weights)) if weights_b is None else None
    carried = view_order == "sequential" and _carry_enabled()
    log.debug("deconvolve: carried fused chain %s", carried)
    step = functools.partial(rl_view_step_fused, conj_k2=conj_k2)
    if psi.ndim > 3:
        trace_print(f"deconvolve: a batch of {nb} on fused, entry by entry")

    entries = psi.reshape((nb,) + spatial)
    out = torch.empty(psi.shape, dtype=psi.dtype, device=psi.device) if nb == 0 else None
    msqs = []
    for b in range(nb):
        views_e = views if views_b is None else transposed(views_b[:, b])
        weights_e = weights if weights_b is None else list(transposed(weights_b[:, b]))
        p = transposed(entries[b])
        sweep = _sweep(step, views_e, weights_e, k1, k2, lam, min_value, view_order, carried,
                       conj_k2=conj_k2)
        # the carried chain's state is (psi, pass A of psi); deltas are on psi
        state = (p, fused_forward_transposed(p)) if carried else p
        p, msq = _iterate(state, sweep, num_iterations, track, carried)
        if out is None:
            # made once the first entry's pass temporaries are freed, so a
            # single volume peaks where it did when it was untransposed last
            out = torch.empty(psi.shape, dtype=psi.dtype, device=psi.device)
        out.view((nb,) + spatial)[b].copy_(p.transpose(-1, -2))
        msqs.append(msq)
        # free this entry's operands before the next entry's are made
        del views_e, weights_e, p, state, sweep
    return (out, _deltas(msqs, out)) if track else out


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
