"""Synthetic multi-view data (numpy only).

Counterpart of ``libmultiviewnative_tpu/utils/synthetic.py``, after the
reference's ``bench/synthetic_data.hpp``: ``multiview_data`` (:47-127) makes
N views with 21³ / 25³ delta kernels, constant images and weights 1/N;
Gaussian PSFs give correctness work non-trivial kernels.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..deconv.workspace import View


def delta_kernel(shape: Sequence[int]) -> np.ndarray:
    """All zeros with a 1 at the center voxel."""
    k = np.zeros(tuple(int(s) for s in shape), np.float32)
    k[tuple(s // 2 for s in k.shape)] = 1.0
    return k


def gaussian_kernel(shape: Sequence[int], sigma: float = 2.0) -> np.ndarray:
    """Normalized isotropic Gaussian PSF on the given support."""
    axes = [np.arange(int(s), dtype=np.float64) - (int(s) // 2) for s in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    r2 = sum(g * g for g in grids)
    k = np.exp(-r2 / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def ramp_image(shape: Sequence[int]) -> np.ndarray:
    """image.flat[i] = i, the analytic fixture's base image."""
    shape = tuple(int(s) for s in shape)
    return np.arange(np.prod(shape), dtype=np.float32).reshape(shape)


def multiview_data(
    num_views: int,
    image_shape: Sequence[int],
    kernel1_shape: Sequence[int] = (21, 21, 21),
    kernel2_shape: Sequence[int] = (25, 25, 25),
    kernel: str = "delta",
    seed: int = 0,
) -> List[View]:
    """N synthetic views.  ``kernel``: "delta" reproduces the reference bench
    workload; "gaussian" gives a non-trivial PSF pair and gamma noise."""
    image_shape = tuple(int(s) for s in image_shape)
    rng = np.random.default_rng(seed)
    make = delta_kernel if kernel == "delta" else gaussian_kernel
    views = []
    for _ in range(num_views):
        img = np.full(image_shape, 128.0, np.float32)
        if kernel != "delta":
            img += rng.gamma(2.0, 10.0, image_shape).astype(np.float32)
        views.append(
            View(
                image=img,
                kernel1=make(kernel1_shape),
                kernel2=make(kernel2_shape),
                weights=np.full(image_shape, 1.0 / num_views, np.float32),
            )
        )
    return views
