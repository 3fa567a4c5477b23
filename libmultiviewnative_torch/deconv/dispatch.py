"""Execution-strategy dispatch on one device: in-core, interleaved, streamed.

Counterpart of ``libmultiviewnative_tpu/deconv/dispatch.py``, the recast of
the reference's GPU heuristic (``src/multiviewnative.cu:89-142``: all on the
device iff ``(4V+2)*stack + fft_workarea < 0.9*GMEM``, else PCIe
streaming).  The ladder here counts one device:

  1. the in-core working set fits        -> :func:`.rl.deconvolve`
  2. psi and the spectra fit, views don't -> :func:`.interleaved.
                                             deconvolve_interleaved`
  3. otherwise                           -> :func:`.streamed.
                                             deconvolve_streamed`

The JAX ladder's mesh rungs (z-only and view-sharded) are not ported: with
more than one CUDA device visible, a request the JAX package would shard
takes the next single-device rung here.  The decision is printed under
``LMVN_TRACE``, like the reference's stdout notice
(``multiviewnative.cu:120-124``).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..utils.trace import trace_print
from .interleaved import deconvolve_interleaved
from .rl import _auto_device, deconvolve, resolve_algorithm
from .streamed import deconvolve_streamed
from .workspace import MultiViewData, check_simultaneous_weights


class DispatchDivergenceWarning(UserWarning):
    """A requested option cannot be honoured on the selected rung and the
    delivered math differs from the request (e.g. a simultaneous view order
    served by a sequential rung)."""


def estimate_workspace_bytes(data: MultiViewData, algorithm: str = "fft", device=None) -> int:
    """The in-core working set: views and weights (2V volumes), both kernel
    spectrum sets and ~8 volumes of psi and temporaries (the reference's
    ``(4V+2)*stack + workarea``, ``src/multiviewnative.cu:97-114``).

    Spectra: a hermitian half-spectrum (fft, compact dft) is about one f32
    volume per kernel per view; the split pairs of fused and of the
    long-axis dft plan (any axis over 256) about two; direct keeps the
    kernels spatial.  ``algorithm`` resolves as on ``device``
    (:func:`.rl.resolve_algorithm`)."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    V = data.num_views
    algo = resolve_algorithm(algorithm, spatial, device)
    spectrum_vols = 1
    if algo == "fused" or (algo == "dft" and max(spatial) > 256):
        spectrum_vols = 2
    elif algo == "direct":
        spectrum_vols = 0
    return (2 * V) * vol + 2 * V * spectrum_vols * vol + 8 * vol


def estimate_interleaved_bytes(data: MultiViewData, algorithm: str = "auto", device=None) -> int:
    """The interleaved rung's device working set: psi, 3 temporaries, the
    current and the prefetched view's slots, and both kernel spectrum sets;
    views and weights stay on the host."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    V = data.num_views
    algo = resolve_algorithm(
        algorithm if algorithm in ("fft", "dft", "fused", "auto") else "auto", spatial, device
    )
    spectrum_vols = 2 if algo == "fused" or (algo == "dft" and max(spatial) > 256) else 1
    return (6 + 2 * V * spectrum_vols) * vol


def device_capacity_bytes(device=None) -> int:
    """The memory of ``device`` (default: the card when there is one): on a
    CUDA device its total from
    ``torch.cuda.mem_get_info``; elsewhere 16 GiB, the JAX package's fixed
    figure for a device that reports none, so the rung decisions there match
    JAX's."""
    dev = _auto_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return 16 * 1024**3


def _host_views(data: MultiViewData):
    """Per-view host tensors of the views, kernels and weights (scalar
    weights as Python floats)."""
    cpu = lambda t: t.detach().to("cpu", torch.float32)
    weights = cpu(data.weights)
    ws = [float(w) for w in weights.tolist()] if weights.ndim == 1 else list(weights)
    return list(cpu(data.views)), list(cpu(data.kernel1)), list(cpu(data.kernel2)), ws


def deconvolve_auto(
    psi: torch.Tensor,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "auto",
    headroom: float = 0.9,
    chunk_z="auto",
    adjoint_kernel2: bool = False,
    view_order: str = "sequential",
    strict: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Run RL on the rung of the ladder that fits ``device``.

    ``psi`` and ``data`` may be host or device tensors, so that a stack
    larger than the card can be passed at all; the in-core rung moves them
    to ``device``.  Every rung returns a tensor on psi's device.  The ladder
    counts one device (the mesh rungs are not ported).

    Option fidelity, as in the JAX package:

    * ``algorithm`` reaches every rung.  The interleaved rung runs fft, dft
      and fused (an explicit ``"direct"`` skips it); the streamed rung fft,
      dft and direct, so a ``"fused"`` request there diverges to the rung's
      ``"auto"``.
    * ``adjoint_kernel2``: the off-core rungs take kernel2 as the flipped
      kernel1, the in-core rung the conjugate spectrum (odd kernel1 dims
      required).
    * ``view_order``: the off-core rungs run the sequential order.  A
      request a rung cannot honour raises ``ValueError`` with ``strict``,
      else warns with :class:`DispatchDivergenceWarning` and runs the
      rung's own.
    * ``headroom``: the share of the device's memory the working set may
      take; ``chunk_z``: the z-chunk of the off-core rungs (``"auto"``: 64
      interleaved, :func:`.streamed.pick_chunk_z` streamed).
    """
    dev = torch.device(device)
    spatial = data.spatial_shape
    est = estimate_workspace_bytes(data, algorithm, dev)
    if adjoint_kernel2:
        # the split-spectrum engines share k1's re part with conj(k1) and
        # materialise only the negated im: one f32 volume less per view
        algo = resolve_algorithm(algorithm, spatial, dev)
        if algo == "fused" or (algo == "dft" and max(spatial) > 256):
            est -= data.num_views * 4 * math.prod(spatial)
        if any(int(d) % 2 == 0 for d in data.kernel1.shape[-3:]):
            raise ValueError(
                f"adjoint_kernel2 requires odd kernel1 dims; got {tuple(data.kernel1.shape[-3:])}"
            )
    cap = int(headroom * device_capacity_bytes(dev))

    if view_order == "simultaneous":
        check_simultaneous_weights(data.weights)

    def diverge(msg: str):
        if strict:
            raise ValueError(msg + " (strict=True)")
        warnings.warn(msg, DispatchDivergenceWarning, stacklevel=3)

    if est < cap:
        trace_print(f"dispatch: in-core on one device (est {est >> 20} MiB < {cap >> 20} MiB)")
        out = deconvolve(
            psi.to(dev), data.to(dev), num_iterations, lam=lam, min_value=min_value,
            view_order=view_order, algorithm=algorithm, adjoint_kernel2=adjoint_kernel2,
        )
        return out.to(psi.device)

    def demote(rung: str, supported: tuple) -> str:
        """An engine the rung cannot honour diverges loudly to the rung's
        own ``"auto"``."""
        if algorithm in supported:
            return algorithm
        diverge(
            f"deconvolve_auto selected the {rung} rung, where algorithm={algorithm!r} is not "
            "available — falling back to the rung's 'auto' engine selection."
        )
        return "auto"

    views, k1, k2, ws = _host_views(data)
    if adjoint_kernel2:
        k2 = [torch.flip(k, dims=(-3, -2, -1)) for k in k1]
    psi_host = psi.detach().to("cpu", torch.float32)
    if torch.cuda.device_count() > 1:
        trace_print("dispatch: counting one device (the mesh rungs are not ported)")

    est_il = estimate_interleaved_bytes(data, algorithm, dev)
    if algorithm != "direct" and est_il < cap:
        if view_order == "simultaneous":
            diverge(
                "deconvolve_auto selected the interleaved rung, which runs the SEQUENTIAL view "
                "order — the requested simultaneous math will differ."
            )
        trace_print(
            f"dispatch: interleaved on one device (est {est_il >> 20} MiB device-resident, "
            f"views streamed; in-core would need {est >> 20} MiB of {cap >> 20} MiB)"
        )
        out = deconvolve_interleaved(
            psi_host, views, k1, k2, ws, num_iterations, lam=lam, min_value=min_value,
            chunk_z=64 if chunk_z == "auto" else chunk_z, algorithm=algorithm, device=dev,
        )
        return torch.from_numpy(np.asarray(out)).to(psi.device)

    trace_print(f"dispatch: streamed on one device (est {est >> 20} MiB > {cap >> 20} MiB)")
    if view_order == "simultaneous":
        diverge(
            "deconvolve_auto selected the streamed rung, which runs the SEQUENTIAL view order "
            "— the requested simultaneous math will differ."
        )
    out = deconvolve_streamed(
        psi_host, views, k1, k2, ws, num_iterations, lam, min_value, chunk_z=chunk_z,
        algorithm=demote("streamed", ("fft", "dft", "direct", "auto")), device=dev,
    )
    return out.to(psi.device)
