"""Mesh-sharded multi-view RL deconvolution (view axis × z-block axis).

Counterpart of ``libmultiviewnative_tpu/parallel/sharded.py``.  The volume
and the view set are laid out over a ('view', 'z') grid of cells, each cell
a ``torch.device`` owned by one process:

  * ``view``: each cell computes its views' updates; the weighted deltas
    are summed over the cells of a z column (the simultaneous order);
  * ``z``: the volume is split into z blocks; each convolve runs as
    overlap-save with a ring halo exchange (:mod:`.halo`), exact for the
    global circular boundary.

JAX runs one program over the mesh through ``shard_map``.  Here a process
drives its own cells in turn: between two local cells a halo or a view sum
is a tensor copy and add; between processes the halo goes by
``batch_isend_irecv`` and the view sum by one ``all_reduce`` per z column
on a group :func:`make_mesh` creates.  A device may repeat in the list, so
one CPU or one card can stand in for several cells.

Each view step runs the port's kernels at the block shapes: the fft engine
K3 (and cuFFT), the quotient K2 and the update K1; the fused engine K4, K6,
K7 per z-block convolve, or with one z block the whole step (K4, K6, K8,
K6, K9).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.shapes import halo_widths
from ..deconv.rl import _apply_update, _fused_timed, _select_rl_update, rl_view_step_fused
from ..deconv.workspace import MultiViewData, check_simultaneous_weights
from ..ops.elementwise import quotient, rl_update
from ..ops.fused import check_transposed_shape, fused_limit, kernel_spectrum_fused
from .distributed import process_count, process_index
from .halo import (
    convolve_zblock,
    convolve_zblock_dft,
    convolve_zblock_fused,
    zblock_fused_extent,
    zblock_kernel_spectrum,
    zblock_kernel_spectrum_fused,
    zblock_kernel_spectrum_split,
)

Cell = Tuple[int, int]

PSI = ("z",)
STACK = ("view", "z")
PER_VIEW = ("view",)


class Mesh:
    """A (view, z) grid of cells: ``devices[v, z]`` is a cell's
    ``torch.device`` on the process ``ranks[v, z]``.  ``shape`` is
    ``{"view": vp, "z": zp}``; ``local_cells`` are this process's cells.
    Built by :func:`make_mesh`."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray, rank: int):
        self.devices = devices
        self.ranks = ranks
        self.rank = int(rank)
        vp, zp = devices.shape
        self.shape = {"view": int(vp), "z": int(zp)}
        self.local_cells: List[Cell] = [
            (v, z) for v in range(vp) for z in range(zp) if ranks[v, z] == rank
        ]
        self.column_groups: Dict[int, object] = {}

    @property
    def size(self) -> int:
        return self.shape["view"] * self.shape["z"]

    def device(self, cell: Cell) -> torch.device:
        return self.devices[cell]

    def rank_of(self, cell: Cell) -> int:
        return int(self.ranks[cell])

    def is_local(self, cell: Cell) -> bool:
        return int(self.ranks[cell]) == self.rank

    @property
    def all_local(self) -> bool:
        return len(self.local_cells) == self.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass devices= (e.g. ['cpu'] * n) "
            "for CPU cells"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(view_parallel: int = 1, z_parallel: Optional[int] = None, devices=None) -> Mesh:
    """Build a ('view', 'z') mesh (the reference's device-memory dispatch,
    ``src/multiviewnative.cu:89-142``: capacity comes from cells along
    'z', throughput from 'view').

    ``devices``: this process's devices, by default the visible CUDA
    devices; a device may repeat, and each entry is one cell.  Across
    processes (:func:`.distributed.initialize_multihost`) every process
    passes as many devices and calls this with the same arguments: the
    cells are its devices in rank order, laid out row by row, and the view
    sum's groups (one per z column) are created here, collectively."""
    if devices is None:
        devices = _visible_cuda_devices()
    if isinstance(devices, np.ndarray):
        devices = devices.ravel().tolist()
    local = [torch.device(d) for d in devices]
    world, rank = process_count(), process_index()
    n = len(local) * world
    if z_parallel is None:
        z_parallel = n // view_parallel
    if view_parallel * z_parallel != n:
        raise ValueError(f"{view_parallel}x{z_parallel} mesh != {n} devices")
    cells = np.empty(n, dtype=object)
    cells[:] = local * world
    ranks = np.repeat(np.arange(world), len(local))
    mesh = Mesh(cells.reshape(view_parallel, z_parallel), ranks.reshape(view_parallel, z_parallel),
                rank)
    if dist.is_available() and dist.is_initialized():
        for z in range(z_parallel):
            members = sorted({int(r) for r in mesh.ranks[:, z]})
            mesh.column_groups[z] = dist.new_group(members)
    return mesh


def view_sum(blocks: Dict[Cell, torch.Tensor], mesh: Mesh) -> Dict[Cell, torch.Tensor]:
    """Each local cell's block summed over the view axis of its z column:
    the local cells' blocks first, then one ``all_reduce`` over the
    column's processes where the mesh spans several.  Cells of one column
    on one device share the returned tensor (read it, do not write it)."""
    out = {}
    for z in sorted({c[1] for c in blocks}):
        cells = sorted(c for c in blocks if c[1] == z)
        total = blocks[cells[0]].clone()
        for c in cells[1:]:
            total += blocks[c].to(total.device)
        if z in mesh.column_groups:
            dist.all_reduce(total, group=mesh.column_groups[z])
        for c in cells:
            out[c] = total.to(mesh.device(c))
    return out


class Shard(NamedTuple):
    """One local block of a :class:`MeshTensor`: the counterpart of an
    entry of JAX's ``addressable_shards``."""

    cell: Cell
    device: torch.device
    index: Tuple[slice, ...]
    data: torch.Tensor


class MeshTensor:
    """A global tensor laid out on a mesh: its ``shape``, its
    ``partition`` (the mesh axis of each leading dim: ``("z",)`` for psi,
    ``("view", "z")`` for views and per-voxel weights, ``("view",)`` for
    kernels and scalar weights; other dims and axes are replicated) and the
    blocks of this process's cells."""

    def __init__(self, mesh: Mesh, shape, partition: Sequence[str], blocks: Dict[Cell, torch.Tensor]):
        self.mesh = mesh
        self.shape = torch.Size(int(s) for s in shape)
        self.partition = tuple(partition)
        self.blocks = dict(blocks)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype

    def index(self, cell: Cell) -> Tuple[slice, ...]:
        """The global index of ``cell``'s block."""
        idx = []
        for d, n in enumerate(self.shape):
            axis = self.partition[d] if d < len(self.partition) else None
            if axis is None:
                idx.append(slice(0, n))
                continue
            k = self.mesh.shape[axis]
            pos = cell[0] if axis == "view" else cell[1]
            idx.append(slice(pos * n // k, (pos + 1) * n // k))
        return tuple(idx)

    def local_shards(self) -> List[Shard]:
        return [Shard(c, self.mesh.device(c), self.index(c), b) for c, b in sorted(self.blocks.items())]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (default: the first cell's), where
        every block is local; raises ``ValueError`` otherwise."""
        if not self.mesh.all_local:
            raise ValueError(
                "MeshTensor.full: the mesh spans other processes, whose blocks are not "
                "here; read local_shards()"
            )
        shards = self.local_shards()
        out = torch.empty(self.shape, dtype=self.dtype, device=device or shards[0].device)
        for s in shards:
            out[s.index] = s.data.to(out.device)
        return out

    def __repr__(self) -> str:
        return f"MeshTensor(shape={tuple(self.shape)}, partition={self.partition}, mesh={self.mesh.shape})"


def shard_tensor(t: torch.Tensor, mesh: Mesh, partition: Sequence[str]) -> MeshTensor:
    """Lay a whole tensor out on the mesh: each local cell gets its block on
    its device.  Cells on one device that hold the same block share one
    copy."""
    mt = MeshTensor(mesh, t.shape, partition, {})
    made = {}
    for c in mesh.local_cells:
        idx = mt.index(c)
        key = (tuple((s.start, s.stop) for s in idx), str(mesh.device(c)))
        if key not in made:
            made[key] = t[idx].to(mesh.device(c)).contiguous()
        mt.blocks[c] = made[key]
    return mt


def _weight_partition(weights) -> Tuple[str, ...]:
    return PER_VIEW if weights.ndim == 1 else STACK


def shard_workspace(data: MultiViewData, psi: torch.Tensor, mesh: Mesh) -> Tuple[MeshTensor, MultiViewData]:
    """Place psi and the stacked views onto the mesh with the layouts
    :func:`deconvolve_sharded` expects."""
    return (
        shard_tensor(psi, mesh, PSI),
        MultiViewData(
            views=shard_tensor(data.views, mesh, STACK),
            kernel1=shard_tensor(data.kernel1, mesh, PER_VIEW),
            kernel2=shard_tensor(data.kernel2, mesh, PER_VIEW),
            weights=shard_tensor(data.weights, mesh, _weight_partition(data.weights)),
        ),
    )


def sharded_fused_eligible(spatial, mesh: Mesh, halo: int = 0) -> bool:
    """Whether the fused engine serves a ('view', 'z')-sharded problem of
    global (Z, Y, X) ``spatial`` on ``mesh``: JAX's layout conditions (X
    even, Y and X multiples of 8; with one z block, Z a multiple of 8),
    then on a CUDA cell the kernels' limit (:func:`..ops.fused.fused_limit`:
    each axis at most 2^25) at the local extent: the whole volume with one
    z block, else the
    8-aligned halo-extended block, ``halo`` the largest lo + hi of the
    kernels.  False on the CPU, as JAX's is there ('auto' never takes the
    plain passes; an explicit request still runs them)."""
    Z, Y, X = (int(s) for s in spatial[-3:])
    zsize = mesh.shape["z"]
    if X % 2 or X % 8 or Y % 8:
        return False
    if zsize == 1 and Z % 8:
        return False
    dev = mesh.devices.flat[0]
    if dev.type != "cuda":
        return False
    ze, Y, X = _fused_local_shape(spatial, mesh, halo)
    return fused_limit((ze, X, Y), dev) is None


def _fused_local_shape(spatial, mesh: Mesh, halo: int) -> Tuple[int, int, int]:
    """The (Z, Y, X) a cell's fused engine runs on: the whole volume with
    one z block, else the 8-aligned halo-extended block."""
    Z, Y, X = (int(s) for s in spatial[-3:])
    zsize = mesh.shape["z"]
    return (Z if zsize == 1 else zblock_fused_extent(Z // zsize, halo, 0), Y, X)


def _mesh_algorithm(algorithm: str, spatial, mesh: Mesh, ext_max: int, halo: int) -> str:
    """The engine of a mesh request.  'auto': on a CUDA cell the port's
    H100 rule at the local extent (fused where eligible, ``ext_max`` is at
    least 256 and the local shape is of a class timed against fft,
    :func:`..deconv.rl._fused_timed`, else fft, never dft); on the CPU
    JAX's rule (``sharded.py:309-319``)."""
    if algorithm != "auto":
        return algorithm
    fused = ext_max >= 256 and sharded_fused_eligible(spatial, mesh, halo)
    if mesh.devices.flat[0].type == "cuda":
        timed = fused and _fused_timed(_fused_local_shape(spatial, mesh, halo))
        return "fused" if timed else "fft"
    if fused:
        return "fused"
    return "dft" if ext_max <= 256 else "fft"


def _new_delta(psi):
    return {c: torch.zeros_like(p) for c, p in psi.items()}


def _at(per_cell, l):
    return {c: x[l] for c, x in per_cell.items()}


def _blend(psi, delta, mesh):
    for c, d in view_sum(delta, mesh).items():
        psi[c].add_(d)
    return psi


def _local_view_sweep(psi, views, kernel1, kernel2, weights, lam, min_value, lo1, hi1, lo2, hi2,
                      mesh, algorithm="fft", update_fn=rl_update):
    """One simultaneous RL sweep over each cell's views on z blocks.

    ``psi``: {cell: (Bz, Y, X)}, replicated over 'view'; ``views``:
    {cell: (Vl, Bz, Y, X)}; ``kernel1``/``kernel2``/``weights``: {cell:
    per-view list} of spectra at the halo-extended extent and of weights.
    The local weighted deltas are summed first, then over 'view'."""
    conv = convolve_zblock_dft if algorithm == "dft" else convolve_zblock
    delta = _new_delta(psi)
    for l in range(len(next(iter(kernel1.values())))):
        integral = conv(psi, _at(kernel1, l), lo1, hi1, mesh)
        for c in psi:
            quotient(views[c][l], integral[c], out=integral[c])
        integral = conv(integral, _at(kernel2, l), lo2, hi2, mesh)
        for c, p in psi.items():
            new = _apply_update(update_fn, p, integral[c], weights[c][l], lam, min_value, integral[c])
            delta[c] += new - p
    return _blend(psi, delta, mesh)


def _fused_zblock_step(psi_t, views_t, k1, k2, weights, l, lam, min_value, lo1, hi1, lo2, hi2,
                       mesh, update_fn, in_place=False):
    """One view's update on transposed z blocks: two overlap-save fused
    convolves with K2 and K1 between them.  Returns {cell: new psi}, written
    over psi with ``in_place``."""
    blurred = convolve_zblock_fused(psi_t, _at(k1, l), lo1, hi1, mesh)
    for c in psi_t:
        quotient(views_t[c][l], blurred[c], out=blurred[c])
    integral = convolve_zblock_fused(blurred, _at(k2, l), lo2, hi2, mesh)
    return {c: _apply_update(update_fn, p, integral[c], weights[c][l], lam, min_value,
                             p if in_place else integral[c])
            for c, p in psi_t.items()}


def _local_view_sweep_fused(psi_t, views_t, k1, k2, weights, lam, min_value, lo1, hi1, lo2, hi2,
                            full_volume: bool, mesh, update_fn=rl_update):
    """One simultaneous RL sweep with the fused engine on TRANSPOSED
    (Bz, X, Y) blocks.  ``full_volume`` (one z block): each view step is
    the fused RL step (K4, K6, K8, K6, K9); else two overlap-save fused
    convolves (K4, K6, K7 each) with K2 and K1 between them."""
    delta = _new_delta(psi_t)
    for l in range(len(next(iter(k1.values())))):
        if full_volume:
            new = {c: rl_view_step_fused(p, views_t[c][l], k1[c][l], k2[c][l], weights[c][l], lam,
                                         min_value)
                   for c, p in psi_t.items()}
        else:
            new = _fused_zblock_step(psi_t, views_t, k1, k2, weights, l, lam, min_value, lo1, hi1,
                                     lo2, hi2, mesh, update_fn)
        for c, p in psi_t.items():
            delta[c] += new[c] - p
    return _blend(psi_t, delta, mesh)


def _local_view_sweep_sequential(psi, views, kernel1, kernel2, weights, lam, min_value, lo1, hi1,
                                 lo2, hi2, mesh, algorithm="fft", update_fn=rl_update):
    """One SEQUENTIAL sweep over all views on each cell's z block, the
    reference's view loop (``src/multiviewnative.cpp:191-228``): the z
    split lives inside each view step, so each view reads the psi the
    previous one wrote.  Only on a z-only mesh (checked by the caller)."""
    conv = convolve_zblock_dft if algorithm == "dft" else convolve_zblock
    for l in range(len(next(iter(kernel1.values())))):
        integral = conv(psi, _at(kernel1, l), lo1, hi1, mesh)
        for c in psi:
            quotient(views[c][l], integral[c], out=integral[c])
        integral = conv(integral, _at(kernel2, l), lo2, hi2, mesh)
        for c, p in psi.items():
            psi[c] = _apply_update(update_fn, p, integral[c], weights[c][l], lam, min_value, p)
    return psi


def _local_view_sweep_sequential_fused(psi_t, views_t, k1, k2, weights, lam, min_value, lo1, hi1,
                                       lo2, hi2, full_volume: bool, mesh, update_fn=rl_update):
    """The sequential sweep with the fused engine on TRANSPOSED z blocks:
    the fused RL step per view with one z block, else the z-block step of
    :func:`_local_view_sweep_fused`, carrying psi through the views."""
    for l in range(len(next(iter(k1.values())))):
        if full_volume:
            for c, p in psi_t.items():
                psi_t[c] = rl_view_step_fused(p, views_t[c][l], k1[c][l], k2[c][l], weights[c][l],
                                              lam, min_value, out=p)
        else:
            psi_t = _fused_zblock_step(psi_t, views_t, k1, k2, weights, l, lam, min_value, lo1,
                                       hi1, lo2, hi2, mesh, update_fn, in_place=True)
    return psi_t


def _on_mesh(x, mesh: Mesh, partition) -> MeshTensor:
    """``x`` as a MeshTensor of ``mesh`` with ``partition``: a plain tensor
    is laid out; a MeshTensor must already be so."""
    if isinstance(x, MeshTensor):
        if x.mesh is not mesh:
            raise ValueError("deconvolve_sharded: a MeshTensor of another mesh was passed")
        if x.partition != tuple(partition):
            raise ValueError(
                f"deconvolve_sharded: expected partition {tuple(partition)}, got {x.partition}"
            )
        return x
    if not mesh.all_local:
        raise ValueError(
            "deconvolve_sharded: on a mesh across processes pass MeshTensors "
            "(shard_workspace or load_sharded_workspace)"
        )
    return shard_tensor(torch.as_tensor(x), mesh, partition)


def _audit_weights(weights: MeshTensor, mesh: Mesh) -> None:
    """The simultaneous order's weight audit (sum over views ~ 1), block by
    block: the local sums, then the view sum."""
    sums = {c: b.sum(dim=0) for c, b in weights.blocks.items()}
    seen = set()
    for c, t in sorted(view_sum(sums, mesh).items()):
        if c[1] not in seen:
            seen.add(c[1])
            check_simultaneous_weights(t.unsqueeze(0))


def _spectra(kernels: MeshTensor, mesh: Mesh, forward) -> Dict[Cell, list]:
    """{cell: [forward(kernel) per local view]}, forwarded once per
    (device, block)."""
    out, made = {}, {}
    for c, kb in kernels.blocks.items():
        key = (str(mesh.device(c)), tuple((s.start, s.stop) for s in kernels.index(c)))
        if key not in made:
            made[key] = [forward(k) for k in kb]
        out[c] = made[key]
    return out


def deconvolve_sharded(
    psi,
    data: MultiViewData,
    num_iterations: int,
    mesh: Mesh,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "fft",
    elementwise: str = "jnp",
    view_order: str = "simultaneous",
):
    """Sharded RL deconvolution: views over mesh axis 'view', z blocks over
    mesh axis 'z'.  Returns psi as it came: a MeshTensor in the ``("z",)``
    layout, or a plain tensor on psi's device where psi was one (the data's
    plain tensors are laid out too, where the mesh is all local).

    Checked: V divisible by the 'view' axis, Z by the 'z' axis, and each z
    block at least as large as the PSF halo.

    ``view_order``: ``"simultaneous"``, every view's update from the same
    psi, the weighted deltas summed over 'view' (the only order a
    view-sharded mesh computes); ``"sequential"``, the reference's view loop
    on a z-only mesh (view axis 1; raises otherwise), the z split inside
    each view step.

    ``algorithm``: ``"fft"``, ``"dft"``, ``"fused"`` or ``"auto"``
    (:func:`_mesh_algorithm`).  ``elementwise``: ``"jnp"`` or ``"pallas"``,
    both K1."""
    vsize, zsize = mesh.shape["view"], mesh.shape["z"]
    if view_order not in ("simultaneous", "sequential"):
        raise ValueError(f"unknown view_order {view_order!r}")
    sequential = view_order == "sequential"
    if sequential and vsize != 1:
        raise ValueError(
            "view_order='sequential' (reference-parity math) requires a z-only mesh "
            f"(view axis == 1); got view axis {vsize}.  The sequential update chain cannot "
            "be computed with views sharded across devices."
        )
    V = data.num_views
    Z = int(psi.shape[-3])
    if V % vsize:
        raise ValueError(f"{V} views not divisible by view axis {vsize}")
    if Z % zsize:
        raise ValueError(f"Z={Z} not divisible by z axis {zsize}")
    (lo1, _, _), (hi1, _, _) = halo_widths(tuple(data.kernel1.shape[-3:]))
    (lo2, _, _), (hi2, _, _) = halo_widths(tuple(data.kernel2.shape[-3:]))
    bz = Z // zsize
    if bz < max(lo1, hi1, lo2, hi2):
        raise ValueError(
            f"Z block {bz} smaller than PSF halo {max(lo1, hi1, lo2, hi2)}; use fewer z shards"
        )
    if algorithm not in ("fft", "dft", "fused", "auto"):
        raise ValueError(
            f"sharded rung supports algorithm 'fft'|'dft'|'fused'|'auto', got {algorithm!r}"
        )
    spatial = tuple(int(s) for s in psi.shape[-3:])
    local_spatial = (bz, spatial[1], spatial[2])
    halo = max(lo1 + hi1, lo2 + hi2)
    ext_max = max(bz + halo, spatial[1], spatial[2])
    algo = _mesh_algorithm(algorithm, spatial, mesh, ext_max, halo)
    full_volume = zsize == 1
    if algo == "fused":
        Y, X = spatial[1], spatial[2]
        if X % 2 or X % 8 or Y % 8 or (full_volume and bz % 8):
            raise ValueError(
                "sharded fused engine requires even X, Y/X multiples of 8 (and Bz % 8 when the "
                f"z axis is 1); got local block {local_spatial} on mesh {dict(mesh.shape)}"
            )
        ze = bz if full_volume else max(zblock_fused_extent(bz, lo1, hi1),
                                        zblock_fused_extent(bz, lo2, hi2))
        check_transposed_shape((ze, X, Y), mesh.devices.flat[0])
    update_fn = _select_rl_update(elementwise)

    plain = not isinstance(psi, MeshTensor)
    out_device = psi.device if plain else None
    psi_m = _on_mesh(psi, mesh, PSI)
    views = _on_mesh(data.views, mesh, STACK)
    k1m = _on_mesh(data.kernel1, mesh, PER_VIEW)
    k2m = _on_mesh(data.kernel2, mesh, PER_VIEW)
    wm = _on_mesh(data.weights, mesh, _weight_partition(data.weights))
    if not sequential:
        _audit_weights(wm, mesh)

    fused = algo == "fused"
    if fused:
        forward = (lambda k: kernel_spectrum_fused(k, local_spatial)) if full_volume else (
            lambda k: zblock_kernel_spectrum_fused(k, local_spatial))
    elif algo == "dft":
        forward = lambda k: zblock_kernel_spectrum_split(k, local_spatial)  # noqa: E731
    else:
        forward = lambda k: zblock_kernel_spectrum(k, local_spatial)  # noqa: E731
    k1, k2 = _spectra(k1m, mesh, forward), _spectra(k2m, mesh, forward)

    def prep(t):  # the fused engine's (Z, X, Y) domain, once per call
        return t.transpose(-1, -2).contiguous() if fused else t

    p = {c: prep(b).clone(memory_format=torch.contiguous_format) for c, b in psi_m.blocks.items()}
    vb = {c: prep(b) for c, b in views.blocks.items()}
    if wm.ndim == 1:
        wb = {c: [float(w) for w in b.tolist()] for c, b in wm.blocks.items()}
    else:
        wb = {c: list(prep(b)) for c, b in wm.blocks.items()}

    halos = (lo1, hi1, lo2, hi2)
    for _ in range(int(num_iterations)):
        if fused:
            sweep = _local_view_sweep_sequential_fused if sequential else _local_view_sweep_fused
            p = sweep(p, vb, k1, k2, wb, lam, min_value, *halos, full_volume, mesh, update_fn)
        else:
            sweep = _local_view_sweep_sequential if sequential else _local_view_sweep
            p = sweep(p, vb, k1, k2, wb, lam, min_value, *halos, mesh, algo, update_fn)
    if fused:
        p = {c: b.transpose(-1, -2).contiguous() for c, b in p.items()}
    out = MeshTensor(mesh, spatial, PSI, p)
    return out.full(out_device) if plain else out


def deconvolve_sharded_jit(
    psi,
    data: MultiViewData,
    num_iterations: int,
    mesh: Mesh,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "fft",
    elementwise: str = "jnp",
    view_order: str = "simultaneous",
):
    """:func:`deconvolve_sharded` under JAX's jitted name.  PyTorch runs
    eagerly, so nothing is compiled and λ/min_value are runtime values on
    every engine; unlike JAX's, psi is not donated."""
    return deconvolve_sharded(psi, data, num_iterations, mesh, lam, min_value, algorithm,
                              elementwise, view_order)
