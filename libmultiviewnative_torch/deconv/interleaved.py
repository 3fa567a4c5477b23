"""Interleaved out-of-core rung: psi on the device, views streamed in.

Counterpart of ``libmultiviewnative_tpu/deconv/interleaved.py``, the
reference's interleaved GPU mode (``src/gpu_deconvolve_methods.cuh:85-326``):
psi, the convolve temporaries and the 2V forwarded kernel spectra live on
the device for the whole call; the views and per-voxel weights stay on the
host and stream in by z-chunks.  Scalar weights stream nothing.  The math is
:func:`.rl.deconvolve` in the sequential order: both convolves run in-core
on the device, the quotient is assembled chunk by chunk with K2, and the
update runs per chunk with K1 (per-voxel weights) or as one whole-volume K1
(a scalar weight).

The kick (``inc/gpu_convolve.cuh:57-98``).  On a CUDA device the host views
and weights are pinned once per call (a caller that keeps them in pinned
CPU tensors saves that copy), and view v+1's chunk copies are
issued on a side stream while view v computes.  Two device slots hold the
views in flight.  The compute stream waits on each chunk's copy event before
it reads the chunk, and the side stream waits on a slot's release event
(recorded after the slot's last reader) before it writes the slot again, so
no buffer is overwritten or freed while a copy or a kernel still uses it.

Host-to-device bytes per iteration: V views, and V weight volumes when the
weights are per-voxel.  Device memory: psi, the two slots, the convolve
temporaries and the 2V spectra.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.shapes import as_shape
from ..ops.elementwise import quotient, rl_update
from .engines import TABLE, forward, resolve_algorithm, select_update

Bounds = List[Tuple[int, int]]


def chunk_bounds(Z: int, chunk_z: int) -> Bounds:
    """The [z0, z1) z-chunks of Z planes; the last may be shorter."""
    return [(z0, min(z0 + chunk_z, Z)) for z0 in range(0, Z, chunk_z)]


def view_step(
    psi: torch.Tensor,
    op1,
    op2,
    convolve: Callable,
    bounds: Bounds,
    chunk: Callable[[int], Tuple[torch.Tensor, Optional[torch.Tensor]]],
    weight,
    lam: float,
    min_value: float,
) -> torch.Tensor:
    """One view's RL update of the device-resident ``psi``, in place.
    ``chunk(i)`` gives the device (view, weight) z-chunk ``bounds[i]``
    (weight None for a scalar ``weight``), ordered after its copy."""
    blurred = convolve(psi, op1)
    for i, (z0, z1) in enumerate(bounds):
        quotient(chunk(i)[0], blurred[z0:z1], out=blurred[z0:z1])
    integral = convolve(blurred, op2)
    del blurred
    if not isinstance(weight, torch.Tensor):
        return rl_update(psi, integral, weight, lam, min_value, out=psi)
    for i, (z0, z1) in enumerate(bounds):
        rl_update(psi[z0:z1], integral[z0:z1], chunk(i)[1], lam, min_value, out=psi[z0:z1])
    return psi


def _host(a) -> torch.Tensor:
    """A contiguous float32 CPU tensor of a numpy array or CPU tensor."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the interleaved rung takes host arrays; got a tensor on {a.device}")
        return a.to(torch.float32).contiguous()
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)) if a.ndim else torch.tensor(float(a))


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` in page-locked host memory: itself when it already is."""
    return t if t.is_pinned() else t.pin_memory()


class _Slots:
    """The views and per-voxel weights on their way to the device.

    On the CPU a chunk is a slice of the host array.  On a CUDA device the
    host arrays are pinned once, and :meth:`upload` copies a view's chunks
    into one of two device slots on the side stream, each chunk followed by
    an event that :meth:`chunk` makes the compute stream wait on;
    :meth:`release` records when the compute stream is done with a slot."""

    def __init__(self, views, weights, shape, bounds: Bounds, dev: torch.device):
        self.bounds, self.dev = bounds, dev
        self.cuda = dev.type == "cuda"
        self.views = [_host(v) for v in views]
        self.weights = list(weights)
        self.current: List[Optional[int]] = [None, None]
        if not self.cuda:
            return
        self.views = [_pinned(v) for v in self.views]
        self.weights = [_pinned(w) if isinstance(w, torch.Tensor) else w for w in weights]
        per_voxel = any(isinstance(w, torch.Tensor) for w in weights)
        self.bufs = [
            (torch.empty(shape, device=dev), torch.empty(shape, device=dev) if per_voxel else None)
            for _ in range(2)
        ]
        self.copy_stream = torch.cuda.Stream(dev)
        self.ready = [[torch.cuda.Event() for _ in bounds] for _ in range(2)]
        self.free = [torch.cuda.Event() for _ in range(2)]

    def upload(self, v: int, slot: int) -> None:
        """Issue view ``v``'s chunk copies into ``slot`` (asynchronous)."""
        self.current[slot] = v
        if not self.cuda:
            return
        view_buf, w_buf = self.bufs[slot]
        w = self.weights[v]
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.free[slot])
            for (z0, z1), ready in zip(self.bounds, self.ready[slot]):
                view_buf[z0:z1].copy_(self.views[v][z0:z1], non_blocking=True)
                if isinstance(w, torch.Tensor):
                    w_buf[z0:z1].copy_(w[z0:z1], non_blocking=True)
                ready.record(self.copy_stream)

    def chunk(self, slot: int, i: int):
        """(view, weight or None) chunk ``i`` of ``slot``'s view on the
        device; on CUDA the current stream waits for its copy first."""
        v = self.current[slot]
        z0, z1 = self.bounds[i]
        w = self.weights[v]
        per_voxel = isinstance(w, torch.Tensor)
        if not self.cuda:
            return self.views[v][z0:z1], w[z0:z1] if per_voxel else None
        torch.cuda.current_stream(self.dev).wait_event(self.ready[slot][i])
        view_buf, w_buf = self.bufs[slot]
        return view_buf[z0:z1], w_buf[z0:z1] if per_voxel else None

    def release(self, slot: int) -> None:
        """The compute stream has issued its last read of ``slot``."""
        if self.cuda:
            self.free[slot].record(torch.cuda.current_stream(self.dev))


def deconvolve_interleaved(
    psi,
    views: Sequence,
    kernels1: Sequence,
    kernels2: Sequence,
    weights: Sequence,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    chunk_z: int = 64,
    algorithm: str = "auto",
    elementwise: str = "jnp",
    device="cuda",
) -> np.ndarray:
    """Sequential RL with psi on ``device`` and the views streamed from the
    host; the same math as :func:`.rl.deconvolve` in the sequential order.

    ``psi``, ``views[v]`` and per-voxel ``weights[v]`` are (Z, Y, X) host
    numpy arrays or CPU tensors; ``weights[v]`` may be a scalar.  Kernels are
    host arrays too.  ``algorithm``: ``"fft"``, ``"dft"``, ``"fused"`` or
    ``"auto"`` (:func:`.engines.resolve_algorithm` of the volume on ``device``).
    ``elementwise``: ``"jnp"`` or ``"pallas"``, both K1 (JAX's choice of
    update chain; another value raises ``ValueError``).
    ``device`` is the PyTorch device the work runs on; on
    ``"cpu"`` the kernels' plain versions run and nothing streams.  Returns
    the final psi as a numpy array.
    """
    select_update(elementwise)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("deconvolve_interleaved: device='cuda' but CUDA is not available")
    psi_host = _host(psi)
    shape = as_shape(psi_host.shape)
    if psi_host.ndim != 3:
        raise ValueError(f"psi must be one (Z, Y, X) volume, got shape {tuple(psi_host.shape)}")
    if algorithm not in ("fft", "dft", "fused", "auto"):
        raise ValueError(
            f"interleaved rung supports algorithm 'fft'|'dft'|'fused'|'auto', got {algorithm!r}"
        )
    engine = resolve_algorithm(algorithm, shape, dev)
    V = len(views)
    if not (len(kernels1) == len(kernels2) == len(weights) == V):
        raise ValueError("views, kernels1, kernels2 and weights must have one entry per view")
    kernels = [[_host(k).to(dev) for k in ks] for ks in (kernels1, kernels2)]
    ops1, ops2, _ = forward(engine, *kernels, shape, dev, per_view=True)

    # scalar weights become Python floats; per-voxel stacks stay host tensors
    host_weights = []
    for w in weights:
        w_host = _host(w)
        if w_host.ndim == 0:
            host_weights.append(float(w_host))
        elif tuple(w_host.shape) != shape:
            raise ValueError(f"weights have shape {tuple(w_host.shape)}, expected {shape}")
        else:
            host_weights.append(w_host)

    bounds = chunk_bounds(shape[0], int(chunk_z))
    slots = _Slots(views, host_weights, shape, bounds, dev)
    psi_dev = psi_host.to(dev, copy=True)
    total = num_iterations * V
    if total:
        slots.upload(0, 0)
    for step in range(total):
        v, slot = step % V, step % 2
        if step + 1 < total:
            slots.upload((v + 1) % V, 1 - slot)  # the kick
        view_step(psi_dev, ops1[v], ops2[v], TABLE[engine].convolve, bounds,
                  lambda i: slots.chunk(slot, i), host_weights[v], lam, min_value)
        slots.release(slot)
    if dev.type == "cpu":
        return psi_dev.numpy()
    # through page-locked memory: a pageable device-to-host copy of a 512³
    # psi took 0.29 s on an H100 host, most of a 2-iteration call's set-up
    out = torch.empty(shape, dtype=torch.float32, pin_memory=True)
    return out.copy_(psi_dev).numpy()
