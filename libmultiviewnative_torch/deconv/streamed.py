"""Streamed out-of-core rung: the volume stays in host memory and passes
through the device in z-chunks.

Counterpart of ``libmultiviewnative_tpu/deconv/streamed.py``, the
reference's interleaved GPU strategy for a workspace larger than the card
(``src/gpu_deconvolve_methods.cuh:85-326``).  The reference's four steps per
view (``src/multiviewnative.cpp:191-228``) become two chunked device passes:

    pass A: quotient[z] = view[z] / (psi_ext (x) k1)[z]         (K2)
    pass B: psi[z]      = rl_update(psi[z], (quot_ext (x) k2)[z], w[z])  (K1)

Each chunk is extended by its kernel's halos, wrapped at the volume's ends
(overlap-save with full halos: the circular boundary), so the result is the
in-core sequential order's, to the rounding of transforms at another
extent.  ``algorithm`` ('fft' | 'dft' | 'direct' | 'auto') is honoured as
on the in-core rung; 'auto' resolves per extended chunk
(:func:`.engines.resolve_algorithm` with ``chunk=True``: never fused).

On a CUDA device the host arrays are pinned once per call (psi, the
quotient, and views and per-voxel weights not pinned already), each chunk
is gathered on the host into one of two pinned staging slots and copied up
on a side stream while the previous chunk computes, and each result comes
back into the host psi or quotient by a non-blocking copy.  Events order
every reuse of a staging slot, a device slot and a host region; each pass
ends with the compute stream synchronised, so the next pass reads complete
host arrays.  On the CPU nothing is copied.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch

from ..core.shapes import halo_widths
from ..ops.elementwise import quotient as quotient_kernel, rl_update
from .engines import TABLE, resolve_algorithm, select_update
from .interleaved import _host, _pinned, chunk_bounds

# chunk working sets on the device at once: one computing, one arriving
INFLIGHT = 2


def _extended_index(Z: int, z0: int, z1: int, lo: int, hi: int) -> torch.Tensor:
    """The planes of chunk [z0, z1) and its halos, wrapped at the ends."""
    return torch.arange(z0 - lo, z1 + hi) % Z


def _gather_extended(vol: torch.Tensor, z0: int, z1: int, lo: int, hi: int, out=None):
    """Chunk [z0, z1) plus circularly wrapped halos of a host volume."""
    return torch.index_select(vol, 0, _extended_index(vol.shape[0], z0, z1, lo, hi), out=out)


def _smooth(n: int) -> bool:
    """2^a * 3^b * 5^c: sizes an FFT library handles at mixed-radix speed."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def pick_chunk_z(Z: int, halo_pairs) -> int:
    """The largest chunk at most min(Z, 256 - the largest halo pair) whose
    extended extent (chunk + halos) is 5-smooth for every kernel's
    ``(lo, hi)`` halo pair: each pass transforms chunk + its own kernel's
    halos, and a power-of-two chunk plus halos lands on slow sizes.
    Without one, warns and falls back to the cap."""
    pairs = sorted({(int(lo), int(hi)) for lo, hi in halo_pairs})
    if not pairs:
        return min(Z, 256)
    cap = min(Z, 256 - max(lo + hi for lo, hi in pairs))
    for c in range(cap, 15, -1):
        if all(_smooth(c + lo + hi) for lo, hi in pairs):
            return c
    fallback = max(cap, 1)
    warnings.warn(
        f"pick_chunk_z: no FFT-friendly chunk for Z={Z}, halos={pairs}; "
        f"falling back to chunk_z={fallback} (extended extents "
        f"{[fallback + lo + hi for lo, hi in pairs]} are not 5-smooth — "
        "expect slow Bluestein-class transforms; pass an explicit chunk_z "
        "or pad the volume to a 5-smooth extent)",
        RuntimeWarning,
        stacklevel=2,
    )
    return fallback


def _convolver(kernel: torch.Tensor, ext_shape, algo: str, dev: torch.device, cache: dict):
    """``convolve(ext)`` for one kernel at one chunk extent, its operand
    forwarded once per (kernel, engine, extent) for the whole call."""
    key = (id(kernel), algo, tuple(ext_shape))
    fn = cache.get(key)
    if fn is None:
        if algo not in ("fft", "dft", "direct"):
            raise ValueError(f"the streamed rung supports fft/dft/direct, not {algo!r}")
        e = TABLE[algo]
        (op,) = e.views([kernel.to(dev)], ext_shape)
        fn = cache[key] = lambda x: e.convolve(x, op)
    return fn


class _Stream:
    """The chunk traffic of one call.  :meth:`run` takes a pass's chunks in
    order: on a CUDA device each extended chunk is gathered into a pinned
    staging slot and copied up, with the chunk's other inputs, on the side
    stream, and each result is copied back into its host region; on the CPU
    the chunks are host tensors and the results are written in place."""

    def __init__(self, dev: torch.device, max_ext_shape):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if not self.cuda:
            return
        self.staging = [torch.empty(max_ext_shape, pin_memory=True) for _ in range(INFLIGHT)]
        self.slots = [torch.empty(max_ext_shape, device=dev) for _ in range(INFLIGHT)]
        self.copy_stream = torch.cuda.Stream(dev)
        self.copied = [torch.cuda.Event() for _ in range(INFLIGHT)]  # slot's inputs are up
        self.read = [torch.cuda.Event() for _ in range(INFLIGHT)]  # slot's last reader issued
        self.staged = [None] * INFLIGHT  # copy events of the staging slots

    def run(self, src: torch.Tensor, out: torch.Tensor, bounds, lo: int, hi: int,
            convolve_of, finish, extras):
        """For each chunk [z0, z1): ``finish(conv[lo:lo+bz], *extras(z0, z1))``
        into ``out[z0:z1]``, where ``conv = convolve_of(ext_shape)(ext)`` of
        the extended chunk of ``src``."""
        rest = tuple(src.shape[1:])
        if not self.cuda:
            for z0, z1 in bounds:
                ext = _gather_extended(src, z0, z1, lo, hi)
                res = convolve_of(tuple(ext.shape))(ext)[lo : lo + (z1 - z0)]
                out[z0:z1] = finish(res, *extras(z0, z1))
            return
        main = torch.cuda.current_stream(self.dev)
        for i, (z0, z1) in enumerate(bounds):
            s = i % INFLIGHT
            n = z1 - z0 + lo + hi
            if self.staged[s] is not None:
                self.staged[s].synchronize()  # the last copy out of this staging slot is done
            stage = self.staging[s][:n]
            _gather_extended(src, z0, z1, lo, hi, out=stage)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.read[s])
                ext = self.slots[s][:n]
                ext.copy_(stage, non_blocking=True)
                up = [t.to(self.dev, non_blocking=True) if isinstance(t, torch.Tensor) else t
                      for t in extras(z0, z1)]
                self.copied[s].record(self.copy_stream)
            self.staged[s] = self.copied[s]
            main.wait_event(self.copied[s])
            for t in up:
                if isinstance(t, torch.Tensor):
                    t.record_stream(main)  # made on the side stream, freed after main's use
            res = convolve_of((n,) + rest)(ext)[lo : lo + (z1 - z0)]
            res = finish(res, *up)
            self.read[s].record(main)
            out[z0:z1].copy_(res, non_blocking=True)
        main.synchronize()  # the host arrays are complete before the next pass


def deconvolve_streamed(
    psi,
    views: Sequence,
    kernels1: Sequence,
    kernels2: Sequence,
    weights: Sequence,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    chunk_z="auto",
    algorithm: str = "fft",
    elementwise: str = "jnp",
    device="cuda",
) -> torch.Tensor:
    """Host-resident sequential RL; the device sees only z-chunks.

    ``psi``, ``views[v]`` and per-voxel ``weights[v]`` are (Z, Y, X) host
    numpy arrays, CPU tensors or arrays that slice along z (an h5py
    dataset); ``weights[v]`` may be a scalar.  ``chunk_z``: an int, or
    ``"auto"`` for :func:`pick_chunk_z`.  ``elementwise``: ``"jnp"`` or ``"pallas"``,
    both K1 (another value raises ``ValueError``).  ``device``: where the chunks run;
    on ``"cpu"`` the kernels' plain versions run and nothing is copied.

    The math is :func:`.rl.deconvolve` in the sequential order.  Returns the
    final psi as a float32 CPU tensor (the JAX rung returns numpy)."""
    select_update(elementwise)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("deconvolve_streamed: device='cuda' but CUDA is not available")
    psi = _host(psi).clone()
    if psi.ndim != 3:
        raise ValueError(f"psi must be one (Z, Y, X) volume, got shape {tuple(psi.shape)}")
    V = len(views)
    if not (len(kernels1) == len(kernels2) == len(weights) == V):
        raise ValueError("views, kernels1, kernels2 and weights must have one entry per view")
    Z = psi.shape[0]
    k1s = [_host(k) for k in kernels1]
    k2s = [_host(k) for k in kernels2]
    halos = [halo_widths(tuple(k.shape)) for k in k1s + k2s]
    if chunk_z == "auto":
        chunk_z = pick_chunk_z(Z, [(lo[0], hi[0]) for lo, hi in halos])
    bounds = chunk_bounds(Z, int(chunk_z))
    max_ext = min(int(chunk_z), Z) + max(lo[0] + hi[0] for lo, hi in halos)

    views = [_host(v) for v in views]
    ws = []
    for w in weights:
        w = _host(w)
        ws.append(float(w) if w.ndim == 0 else w)
    quot = torch.empty_like(psi)
    if dev.type == "cuda":
        psi, quot = _pinned(psi), _pinned(quot)
        views = [_pinned(v) for v in views]
        ws = [_pinned(w) if isinstance(w, torch.Tensor) else w for w in ws]
    stream = _Stream(dev, (max_ext,) + tuple(psi.shape[1:]))
    cache: dict = {}

    def convolve_of(kernel):
        def at(ext_shape):
            algo = resolve_algorithm(algorithm, ext_shape, dev, chunk=True)
            return _convolver(kernel, ext_shape, algo, dev, cache)

        return at

    for _ in range(num_iterations):
        for v in range(V):
            view_v, w_v = views[v], ws[v]
            (lo1, _, _), (hi1, _, _) = halo_widths(tuple(k1s[v].shape))
            (lo2, _, _), (hi2, _, _) = halo_widths(tuple(k2s[v].shape))
            # pass A: quotient = view / (psi (x) k1)
            stream.run(
                psi, quot, bounds, lo1, hi1, convolve_of(k1s[v]),
                lambda blurred, view_c: quotient_kernel(view_c, blurred, out=blurred),
                lambda z0, z1: (view_v[z0:z1],),
            )
            # pass B: psi = rl_update(psi, quotient (x) k2, w)
            stream.run(
                quot, psi, bounds, lo2, hi2, convolve_of(k2s[v]),
                lambda integral, psi_c, w_c: rl_update(psi_c, integral, w_c, lam, min_value,
                                                       out=psi_c),
                lambda z0, z1: (psi[z0:z1], w_v[z0:z1] if isinstance(w_v, torch.Tensor) else w_v),
            )
    return psi
