"""Block-wise data loading for the ('view', 'z') mesh.

Counterpart of ``libmultiviewnative_tpu/parallel/loader.py``.  Every
process runs the same code and reads only the slabs its own cells hold:
one reader call per (view, z-slab) block, so a z-chunked HDF5 read touches
only that slab's chunks.  Cells on one device that hold the same block
share one read.  The result is laid out for :func:`.sharded.deconvolve_sharded`.

Sources per view may be:
  * a numpy array already in host memory (sliced per block);
  * ``"file.h5:dataset"`` (z-chunked HDF5, :func:`..io.stacks.save_stack_h5`):
    each block's read touches only its slab;
  * ``"file.tif"`` or ``"file.npz:name"``: whole-file formats, read once per
    process and then sliced;
  * ``callable(zslice) -> ndarray``: anything else; it returns the
    (len(zslice), Y, X) slab.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..deconv.workspace import MultiViewData
from ..io.stacks import load_stack_npz, read_tiff_stack
from .sharded import PER_VIEW, PSI, STACK, Mesh, MeshTensor, shard_tensor

Source = Union[np.ndarray, str, Callable[[slice], np.ndarray]]


def as_reader(src: Source) -> Callable[[slice], np.ndarray]:
    """A view source as ``reader(zslice) -> (dz, Y, X) float32``."""
    if callable(src):
        return src
    if isinstance(src, np.ndarray):
        arr = np.asarray(src, np.float32)
        return lambda zs: arr[zs]
    if isinstance(src, str):
        if ".h5:" in src or ".hdf5:" in src:
            path, name = src.rsplit(":", 1)

            def read_h5(zs: slice) -> np.ndarray:
                import h5py

                # opened per read: a handle is not shared between callers
                with h5py.File(path, "r") as f:
                    return np.asarray(f[name][zs], np.float32)

            return read_h5
        if ".npz:" in src:
            path, name = src.rsplit(":", 1)
            arr = load_stack_npz(path)[name].astype(np.float32)
            return lambda zs: arr[zs]
        arr = read_tiff_stack(src)
        return lambda zs: arr[zs]
    raise TypeError(f"unsupported view source {type(src).__name__}")


def make_sharded_stack(
    mesh: Mesh,
    readers: Sequence[Callable[[slice], np.ndarray]],
    spatial_shape: Sequence[int],
    spec: Sequence[str] = STACK,
) -> MeshTensor:
    """The global (V, Z, Y, X) stack on the mesh, reading only the blocks of
    this process's cells: one reader call per view of each (view, z-slab)
    block.  Cells on one device that hold the same block share one read."""
    V = len(readers)
    mt = MeshTensor(mesh, (V,) + tuple(int(s) for s in spatial_shape), spec, {})
    made = {}
    for c in mesh.local_cells:
        idx = mt.index(c)
        key = (tuple((s.start, s.stop) for s in idx), str(mesh.device(c)))
        if key not in made:
            slabs = [readers[v](idx[1])[(...,) + tuple(idx[2:])] for v in range(*idx[0].indices(V))]
            made[key] = torch.from_numpy(
                np.ascontiguousarray(np.stack(slabs).astype(np.float32))
            ).to(mesh.device(c))
        mt.blocks[c] = made[key]
    return mt


def _is_scalar(x) -> bool:
    return not callable(x) and not isinstance(x, str) and np.ndim(x) == 0


def _global_mean(views: MeshTensor, mesh: Mesh) -> float:
    """The mean of a ('view', 'z') stack: each block is held by one cell, so
    the local sums, then one sum over the mesh's processes."""
    dev = mesh.device(mesh.local_cells[0])
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for b in views.blocks.values():
        total += b.to(dev).sum(dtype=torch.float64)
    if dist.is_available() and dist.is_initialized() and not mesh.all_local:
        dist.all_reduce(total)
    return float(total) / float(np.prod(views.shape))


def load_sharded_workspace(
    mesh: Mesh,
    views: Sequence[Source],
    kernel1: Sequence[np.ndarray],
    kernel2: Sequence[np.ndarray],
    weights: Union[Sequence[Source], Sequence[float], np.ndarray],
    spatial_shape: Sequence[int],
    psi0: Optional[Source] = None,
) -> Tuple[MeshTensor, MultiViewData]:
    """(psi0, MultiViewData) laid out for :func:`.sharded.deconvolve_sharded`,
    reading per-block slabs only (call it on every process).

    ``views`` and per-voxel ``weights``: per-view sources (:func:`as_reader`).
    ``weights`` may instead be one scalar per view, which reads no bytes.
    Kernels are small: loaded whole on every process, laid out over 'view'.
    ``psi0=None`` gives the flat-average initial guess
    (``tests/tiff_fixtures.hpp:453-462``) from one global mean."""
    shape = tuple(int(s) for s in spatial_shape)
    views_mt = make_sharded_stack(mesh, [as_reader(s) for s in views], shape)

    def kernels(ks):
        return shard_tensor(torch.from_numpy(np.stack([np.asarray(k, np.float32) for k in ks])),
                            mesh, PER_VIEW)

    if all(_is_scalar(x) for x in weights):
        w = shard_tensor(torch.tensor([float(x) for x in weights], dtype=torch.float32), mesh,
                         PER_VIEW)
    else:
        w = make_sharded_stack(mesh, [as_reader(s) for s in weights], shape)

    if psi0 is None:
        mean = _global_mean(views_mt, mesh)
        psi = MeshTensor(mesh, shape, PSI, {})
        for c in mesh.local_cells:
            psi.blocks[c] = torch.full(tuple(s.stop - s.start for s in psi.index(c)), mean,
                                       dtype=torch.float32, device=mesh.device(c))
    else:
        r = as_reader(psi0)
        psi = make_sharded_stack(mesh, [r], shape, spec=(None,) + PSI)
        psi = MeshTensor(mesh, shape, PSI, {c: b[0] for c, b in psi.blocks.items()})
    data = MultiViewData(views=views_mt, kernel1=kernels(kernel1), kernel2=kernels(kernel2),
                         weights=w)
    return psi, data
