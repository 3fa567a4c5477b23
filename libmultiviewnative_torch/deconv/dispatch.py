"""Execution-strategy dispatch: in-core, mesh-sharded, interleaved, streamed.

Counterpart of ``libmultiviewnative_tpu/deconv/dispatch.py``, the recast of
the reference's GPU heuristic (``src/multiviewnative.cu:89-142``: all on the
device iff ``(4V+2)*stack + fft_workarea < 0.9*GMEM``, else PCIe
streaming).  The ladder:

  1. the in-core working set fits        -> :func:`.rl.deconvolve`
  2. more than one device, a sequential  -> :func:`..parallel.sharded.
     request, and a z-only mesh holds it    deconvolve_sharded`, the
                                            reference's view loop on z blocks
  3. more than one device and the fleet  -> the view-sharded mesh (the
     holds it                               simultaneous order)
  4. psi and the spectra fit, views don't -> :func:`.interleaved.
                                             deconvolve_interleaved`
  5. otherwise                           -> :func:`.streamed.
                                             deconvolve_streamed`

The devices are the visible CUDA devices times the processes
(:func:`mesh_device_count`, :func:`mesh_devices`).  The decision is printed
under ``LMVN_TRACE``, like the reference's stdout notice
(``multiviewnative.cu:120-124``).  Under a profiler, a call is the span
``lmvn.call`` and the rung it runs ``lmvn.rung.<name>`` inside it
(:func:`..utils.trace.span`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..core.shapes import halo_widths
from ..utils.trace import span, spanned, trace_print
from .interleaved import deconvolve_interleaved
from .rl import _auto_device, _select_rl_update, deconvolve, resolve_algorithm
from .streamed import deconvolve_streamed
from .workspace import MultiViewData, check_simultaneous_weights


class DispatchDivergenceWarning(UserWarning):
    """A requested option cannot be honoured on the selected rung and the
    delivered math differs from the request (e.g. a simultaneous view order
    served by a sequential rung)."""


def estimate_workspace_bytes(data: MultiViewData, algorithm: str = "fft", device=None,
                             batch: int = 1) -> int:
    """The in-core working set of a psi of ``batch`` volumes: the views and
    weights as they are stored (2V volumes when both are (V, Z, Y, X)), both
    kernel spectrum sets and ~8 volumes of psi and temporaries per batch
    entry (the reference's ``(4V+2)*stack + workarea``,
    ``src/multiviewnative.cu:97-114``).

    Spectra: a hermitian half-spectrum (fft, compact dft) is about one f32
    volume per kernel per view; the split pairs of fused and of the
    long-axis dft plan (any axis over 256) about two; direct keeps the
    kernels spatial.  ``algorithm`` resolves as on ``device``
    (:func:`.rl.resolve_algorithm`; a batch never takes fused).

    The JAX package counts 2V volumes for the views and weights and 8 for
    psi whatever their shapes (its fault R8, ROADMAP): a batched request
    there is taken in-core at the size of one volume."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    V = data.num_views
    algo = resolve_algorithm(algorithm, spatial, device, chunk=batch > 1)
    spectrum_vols = 1
    if algo == "fused" or (algo == "dft" and max(spatial) > 256):
        spectrum_vols = 2
    elif algo == "direct":
        spectrum_vols = 0
    stacks = 4 * (data.views.numel() + data.weights.numel())
    return stacks + 2 * V * spectrum_vols * vol + 8 * batch * vol


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


def mesh_device_count() -> int:
    """The devices the mesh rungs may use: the visible CUDA devices times
    the processes of the process group (the JAX package's
    ``jax.device_count()``)."""
    from ..parallel.distributed import process_count

    return torch.cuda.device_count() * process_count() if torch.cuda.is_available() else 0


def mesh_devices(n: int) -> list:
    """This process's devices for a mesh of ``n`` cells: the first ``n``
    visible CUDA devices, divided among the processes."""
    from ..parallel.distributed import process_count

    return [torch.device("cuda", i) for i in range(n // process_count())]


def _zonly_cell_bytes(data: MultiViewData, algorithm: str, zp: int, device) -> int:
    """One cell's working set on a z-only mesh of ``zp`` cells: its share of
    the z-split volumes (views, weights, psi and temporaries:
    :func:`estimate_workspace_bytes` less the spectra, over ``zp``) plus
    what every cell holds whole, the kernel stacks and all views' spectra at
    the block's halo-extended extent (8-aligned on the fused engine).  The
    JAX package divides the whole estimate by ``zp`` (its fault R2,
    ROADMAP), which undercounts the spectra each cell holds."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    V = data.num_views
    algo = resolve_algorithm(algorithm, spatial, device)
    spectrum_vols = 2 if algo == "fused" or (algo == "dft" and max(spatial) > 256) else 1
    if algo == "direct":
        spectrum_vols = 0
    spectra = 2 * V * spectrum_vols * vol
    sharded = estimate_workspace_bytes(data, algorithm, device) - spectra
    (lo1, _, _), (hi1, _, _) = halo_widths(tuple(data.kernel1.shape[-3:]))
    (lo2, _, _), (hi2, _, _) = halo_widths(tuple(data.kernel2.shape[-3:]))
    ext = spatial[0] // zp + max(lo1 + hi1, lo2 + hi2)
    if algo == "fused":
        ext = -(-ext // 8) * 8
    replicated = spectra * ext // spatial[0]
    replicated += 4 * (data.kernel1.numel() + data.kernel2.numel())
    return sharded // zp + replicated


def _pick_zonly_mesh(data: MultiViewData, algorithm: str, n_dev: int, halo: int, cap: int,
                     device):
    """The largest z-only ('view' = 1) mesh that divides Z, keeps each block
    at least one halo wide (the overlap-save bound), and whose cells each
    hold their working set (:func:`_zonly_cell_bytes` < ``cap``); None if
    none does."""
    from ..parallel.sharded import make_mesh

    Z = data.spatial_shape[0]
    for zp in range(n_dev, 1, -1):
        if Z % zp or (Z // zp) < max(halo, 1):
            continue
        if _zonly_cell_bytes(data, algorithm, zp, device) >= cap:
            continue
        return make_mesh(view_parallel=1, z_parallel=zp, devices=mesh_devices(zp))
    return None


def _pick_mesh(V: int, Z: int, n_dev: int):
    """A ('view', 'z') factorization vp*zp == n_dev with V % vp == 0 and
    Z % zp == 0, the most view-parallel one; None if none exists."""
    from ..parallel.sharded import make_mesh

    best = None
    for vp in range(1, n_dev + 1):
        if n_dev % vp:
            continue
        zp = n_dev // vp
        if V % vp == 0 and Z % zp == 0 and (best is None or vp > best[0]):
            best = (vp, zp)
    if best is None:
        return None
    return make_mesh(view_parallel=best[0], z_parallel=best[1], devices=mesh_devices(n_dev))


def _run_mesh(psi, data, num_iterations, mesh, **kw) -> torch.Tensor:
    from ..parallel.sharded import deconvolve_sharded, shard_workspace

    psi_s, data_s = shard_workspace(data, psi, mesh)
    out = deconvolve_sharded(psi_s, data_s, num_iterations, mesh, **kw)
    return out.full(psi.device)


@spanned("lmvn.call")
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
    elementwise: str = "jnp",
    view_order: str = "sequential",
    strict: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Run RL on the rung of the ladder that fits the devices.

    ``psi`` and ``data`` may be host or device tensors, so that a stack
    larger than the card can be passed at all; the in-core rung moves them
    to ``device``, the mesh rungs to their cells.  Every rung returns a
    tensor on psi's device.  A batched psi (*B, Z, Y, X) runs in-core, its
    estimate counting the batch; when that does not fit it raises
    ``ValueError``, as the other rungs take one volume.

    Option fidelity, as in the JAX package:

    * ``algorithm`` and ``elementwise`` reach every rung.  The mesh rungs run
      fft, dft and fused (fused where :func:`..parallel.sharded.
      sharded_fused_eligible` holds); the interleaved rung fft, dft and
      fused (an explicit ``"direct"`` skips it); the streamed rung fft, dft
      and direct.  An engine a rung cannot run diverges to the rung's
      ``"auto"``.
    * ``adjoint_kernel2``: the off-core rungs take kernel2 as the flipped
      kernel1, the in-core rung the conjugate spectrum (odd kernel1 dims
      required).
    * ``view_order``: a sequential request too big for one device first
      tries a z-only mesh, which runs the reference's view loop exactly.
      Where that mesh exists but cannot run the engine, the request goes on
      to the sequential off-core rungs, not to the simultaneous mesh (the
      JAX package's fault R1, ROADMAP).  Otherwise the view-sharded mesh is
      simultaneous and the off-core rungs sequential: a request a rung
      cannot honour raises ``ValueError`` with ``strict``, else warns with
      :class:`DispatchDivergenceWarning` and runs the rung's own order.
    * ``headroom``: the share of a device's memory a working set may take;
      ``chunk_z``: the z-chunk of the off-core rungs (``"auto"``: 64
      interleaved, :func:`.streamed.pick_chunk_z` streamed).
    """
    _select_rl_update(elementwise)
    dev = torch.device(device)
    spatial = data.spatial_shape
    batch = math.prod(psi.shape[:-3])
    est = estimate_workspace_bytes(data, algorithm, dev, batch=batch)
    if adjoint_kernel2:
        # the split-spectrum engines share k1's re part with conj(k1) and
        # materialise only the negated im: one f32 volume less per view
        algo = resolve_algorithm(algorithm, spatial, dev, chunk=batch > 1)
        if algo == "fused" or (algo == "dft" and max(spatial) > 256):
            est -= data.num_views * 4 * math.prod(spatial)
        if any(int(d) % 2 == 0 for d in data.kernel1.shape[-3:]):
            raise ValueError(
                f"adjoint_kernel2 requires odd kernel1 dims; got {tuple(data.kernel1.shape[-3:])}"
            )
    cap = int(headroom * device_capacity_bytes(dev))
    n_dev = mesh_device_count()

    if view_order == "simultaneous":
        check_simultaneous_weights(data.weights)

    def diverge(msg: str):
        if strict:
            raise ValueError(msg + " (strict=True)")
        # past diverge, this function and its span wrapper: the caller
        warnings.warn(msg, DispatchDivergenceWarning, stacklevel=4)

    if est < cap:
        trace_print(f"dispatch: in-core on one device (est {est >> 20} MiB < {cap >> 20} MiB)")
        with span("lmvn.rung.in_core"):
            out = deconvolve(
                psi.to(dev), data.to(dev), num_iterations, lam=lam, min_value=min_value,
                view_order=view_order, algorithm=algorithm, adjoint_kernel2=adjoint_kernel2,
                elementwise=elementwise,
            )
            return out.to(psi.device)

    if batch > 1:
        # the other rungs take one volume, in the JAX package too
        raise ValueError(
            f"a batch of {batch} volumes of {tuple(spatial)} needs {est >> 20} MiB in core, "
            f"more than {cap >> 20} MiB, and only the in-core rung takes a batch: "
            "deconvolve fewer volumes per call"
        )

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

    if adjoint_kernel2:
        # the remaining rungs take spatial kernel2 stacks
        data = MultiViewData(data.views, data.kernel1,
                             torch.flip(data.kernel1, dims=(-3, -2, -1)), data.weights)

    mesh_rung = n_dev > 1 and est < cap * n_dev
    if mesh_rung:
        from ..parallel.sharded import sharded_fused_eligible

        (lo1, _, _), (hi1, _, _) = halo_widths(tuple(data.kernel1.shape[-3:]))
        (lo2, _, _), (hi2, _, _) = halo_widths(tuple(data.kernel2.shape[-3:]))

        def mesh_engines(mesh) -> tuple:
            halo = max(lo1 + hi1, lo2 + hi2)
            return ("fft", "dft", "auto") + (
                ("fused",) if sharded_fused_eligible(spatial, mesh, halo) else ()
            )

    if mesh_rung and view_order == "sequential":
        mesh = _pick_zonly_mesh(data, algorithm, n_dev, max(lo1, hi1, lo2, hi2), cap, dev)
        if mesh is not None:
            supported = mesh_engines(mesh)
            if algorithm in supported:
                trace_print(
                    f"dispatch: sequential parity on z-only mesh {dict(mesh.shape)} "
                    f"(est {est >> 20} MiB over {mesh.shape['z']} devices)"
                )
                with span("lmvn.rung.mesh"):
                    return _run_mesh(psi, data, num_iterations, mesh, lam=lam,
                                     min_value=min_value, algorithm=algorithm,
                                     elementwise=elementwise, view_order="sequential")
            # R1: the sequential off-core rungs honour both the order and
            # the engine; the simultaneous mesh would honour neither
            trace_print(
                f"dispatch: z-only mesh cannot honour algorithm={algorithm!r}; trying the "
                "sequential off-core rungs"
            )
            mesh_rung = False
        else:
            trace_print("dispatch: no z-only factorization for the sequential request")

    if mesh_rung:
        mesh = _pick_mesh(data.num_views, spatial[0], n_dev)
        if mesh is not None:
            if view_order == "sequential":
                diverge(
                    "deconvolve_auto selected the mesh-sharded rung, which computes the "
                    "SIMULTANEOUS view-order update — the requested sequential "
                    "(reference-parity) math will differ.  Pass view_order='simultaneous' to "
                    "opt in silently, or strict=True to forbid."
                )
                check_simultaneous_weights(data.weights)
            trace_print(
                f"dispatch: sharded mesh {dict(mesh.shape)} (est {est >> 20} MiB over "
                f"{n_dev} devices)"
            )
            with span("lmvn.rung.mesh"):
                return _run_mesh(psi, data, num_iterations, mesh, lam=lam, min_value=min_value,
                                 algorithm=demote("mesh-sharded", mesh_engines(mesh)),
                                 elementwise=elementwise)
        trace_print("dispatch: no valid mesh factorization; streaming")

    # the off-core rungs copy the stacks to the host inside their own span
    est_il = estimate_interleaved_bytes(data, algorithm, dev)
    interleaved = algorithm != "direct" and est_il < cap
    with span("lmvn.rung.interleaved" if interleaved else "lmvn.rung.streamed"):
        views, k1, k2, ws = _host_views(data)
        psi_host = psi.detach().to("cpu", torch.float32)
        if interleaved:
            if view_order == "simultaneous":
                diverge(
                    "deconvolve_auto selected the interleaved rung, which runs the SEQUENTIAL "
                    "view order — the requested simultaneous math will differ."
                )
            trace_print(
                f"dispatch: interleaved on one device (est {est_il >> 20} MiB device-resident, "
                f"views streamed; in-core would need {est >> 20} MiB of {cap >> 20} MiB)"
            )
            out = deconvolve_interleaved(
                psi_host, views, k1, k2, ws, num_iterations, lam=lam, min_value=min_value,
                chunk_z=64 if chunk_z == "auto" else chunk_z, algorithm=algorithm,
                elementwise=elementwise, device=dev,
            )
            return torch.from_numpy(np.asarray(out)).to(psi.device)

        trace_print(f"dispatch: streamed on one device (est {est >> 20} MiB > {cap >> 20} MiB)")
        if view_order == "simultaneous":
            diverge(
                "deconvolve_auto selected the streamed rung, which runs the SEQUENTIAL view "
                "order — the requested simultaneous math will differ."
            )
        out = deconvolve_streamed(
            psi_host, views, k1, k2, ws, num_iterations, lam, min_value, chunk_z=chunk_z,
            algorithm=demote("streamed", ("fft", "dft", "direct", "auto")),
            elementwise=elementwise, device=dev,
        )
        return out.to(psi.device)
