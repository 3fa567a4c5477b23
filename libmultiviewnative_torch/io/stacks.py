"""3D image stack IO: TIFF (multi-page), HDF5 and NPZ.

Counterpart of ``libmultiviewnative_tpu/io/stacks.py``, in numpy as there:
the replacement of the reference's libtiff scanline reader/writer
(``tests/tiff_utils.h:21-162``) and of its ``.shape`` sidecar convention
(``share/extract_shape.sh``, ``tests/tiff_fixtures_helpers.hpp``).  TIFF
goes through imageio and HDF5 through h5py, each imported when first used;
stacks are (z, y, x) float32, page i == z-plane i, matching the reference's
directory-per-plane layout (``tiff_utils.h:40-76``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def read_tiff_stack(path: str, dtype=np.float32) -> np.ndarray:
    """Read a multi-page TIFF into a (z, y, x) array.

    Parity: ``tiff_stack::load`` (tests/tiff_utils.h:21-117),
    including the all-NaN guard of tiff_fixtures.hpp:106-131 (raises here
    instead of warning)."""
    import imageio.v3 as iio

    vol = np.asarray(iio.imread(path), dtype)
    if vol.ndim == 2:
        vol = vol[None]
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a 2D/3D TIFF, got shape {vol.shape}")
    if np.isnan(vol).all():
        raise ValueError(f"{path}: stack is entirely NaN")
    return vol


def write_tiff_stack(path: str, stack: np.ndarray) -> None:
    """Write a (z, y, x) array as a multi-page float32 TIFF.

    Parity: ``write_image_stack`` (tests/tiff_utils.h:119-162)."""
    import imageio.v3 as iio

    stack = np.asarray(stack, np.float32)
    if stack.ndim != 3:
        raise ValueError(f"expected 3D stack, got {stack.shape}")
    iio.imwrite(path, stack)


def write_shape_sidecar(path: str, shape: Sequence[int]) -> None:
    """``<stack>.shape`` sidecar: 'z y x' — the convention of
    share/extract_shape.sh."""
    with open(path, "w") as f:
        f.write(" ".join(str(int(s)) for s in shape) + "\n")


def read_shape_sidecar(path: str):
    with open(path) as f:
        return tuple(int(t) for t in f.read().split())


def save_stack_h5(path: str, chunks_z: int = 16, **stacks: np.ndarray) -> None:
    """HDF5 container with z-chunked layout — the storage side of the
    out-of-core streamed path (deconv.streamed reads z-chunks; chunked
    HDF5 makes those reads O(chunk))."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, a in stacks.items():
            a = np.asarray(a, np.float32)
            cz = min(chunks_z, a.shape[0]) if a.ndim == 3 else None
            f.create_dataset(
                name,
                data=a,
                chunks=(cz,) + a.shape[1:] if cz else None,
                compression="gzip",
                compression_opts=1,
            )


def load_stack_h5(path: str, name: Optional[str] = None):
    """Load one dataset (or a dict of all) from an HDF5 stack file."""
    import h5py

    with h5py.File(path, "r") as f:
        if name is not None:
            return np.asarray(f[name])
        return {k: np.asarray(f[k]) for k in f.keys()}


def open_stack_h5(path: str, name: str):
    """Open a dataset handle for chunked (out-of-core) reads; caller must
    keep the returned file object alive.  Returns (file, dataset)."""
    import h5py

    f = h5py.File(path, "r")
    return f, f[name]


def save_stack_npz(path: str, **stacks: np.ndarray) -> None:
    """Compressed NPZ container for stacks (the in-repo golden format)."""
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in stacks.items()})


def load_stack_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
