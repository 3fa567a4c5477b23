"""Workspace / view containers.

Counterpart of ``libmultiviewnative_tpu/deconv/workspace.py``; the shape of
the reference's C ABI structs (``view_data`` and ``workspace``,
``inc/multiviewnative.h:15-35``).  Views are stacked on a leading axis so
the FFTs run batched.  Kernels of different per-view shapes are
zero-embedded into the max kernel shape keeping each kernel's center voxel:
zero taps are exact no-ops under the wrap convention.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

from ..core.shapes import Shape, as_shape, kernel_center


class WeightNormalizationWarning(UserWarning):
    """Simultaneous-mode weights don't sum to ~1 across views."""


def check_simultaneous_weights(weights, atol: float = 1e-3) -> None:
    """Warn when view weights do not sum to ~1 over the view axis.

    The simultaneous view order blends per-view updates additively
    (psi' = psi + sum_v w_v (new_v - psi)); unnormalized weights scale every
    sweep by sum(w) and can diverge.  Accepts (V,) scalar weights or
    (V, Z, Y, X) and (V, *B, Z, Y, X) stacks, as arrays or tensors (read
    back to the host).
    """
    w = weights.detach().cpu().numpy() if isinstance(weights, torch.Tensor) else np.asarray(weights)
    total = w.sum(axis=0) if w.ndim > 1 else w.sum()
    err = float(np.max(np.abs(np.asarray(total) - 1.0)))
    if err > atol:
        # level 4: the caller of deconvolve or deconvolve_auto, past their
        # span wrappers (utils/trace.py spanned)
        warnings.warn(
            "simultaneous view order expects weights summing to ~1 across "
            f"views (max |sum-1| = {err:.3g}); each sweep is effectively "
            "scaled by sum(w) and may diverge — normalize the weights or "
            "use view_order='sequential'",
            WeightNormalizationWarning,
            stacklevel=4,
        )


@dataclasses.dataclass
class View:
    """One camera view (``view_data``, ``inc/multiviewnative.h:15-26``).

    image   : observed stack phi_v,           (z, y, x) float32
    kernel1 : view PSF P_v,                   (kz, ky, kx)
    kernel2 : compound/adjoint kernel,        (kz', ky', kx')
    weights : per-pixel blending weights w_v, (z, y, x)
    """

    image: np.ndarray
    kernel1: np.ndarray
    kernel2: np.ndarray
    weights: np.ndarray

    def __post_init__(self) -> None:
        if self.image.shape != self.weights.shape:
            raise ValueError(
                f"image {self.image.shape} and weights {self.weights.shape} differ"
            )


def pad_kernel_to(kernel: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Zero-embed a kernel into ``target`` shape keeping its center voxel
    (lo = T//2 - k//2 per axis), so its wrapped spectrum is unchanged."""
    target = as_shape(target)
    lo = tuple(cn - co for cn, co in zip(kernel_center(target), kernel_center(kernel.shape)))
    hi = tuple(t - k - l for t, k, l in zip(target, kernel.shape, lo))
    for d, (l, h) in enumerate(zip(lo, hi)):
        if l < 0 or h < 0:
            raise ValueError(
                f"kernel {kernel.shape} does not fit target {target} on axis {d}"
            )
    return np.pad(kernel, list(zip(lo, hi)))


def _max_shape(shapes: Sequence[Shape]) -> Shape:
    return tuple(int(max(s[d] for s in shapes)) for d in range(len(shapes[0])))


@dataclasses.dataclass
class MultiViewData:
    """Stacked views: the tensors the RL loop consumes.

    views    : (V, Z, Y, X) float32, or (V, *B, Z, Y, X): one view stack per
               entry of a batched psi
    kernel1  : (V, K1z, K1y, K1x)  — common (max) kernel1 shape
    kernel2  : (V, K2z, K2y, K2x)
    weights  : (V, Z, Y, X) per-voxel, (V, *B, Z, Y, X) per batch entry, or
               (V,) one scalar per view
    """

    views: torch.Tensor
    kernel1: torch.Tensor
    kernel2: torch.Tensor
    weights: torch.Tensor

    @property
    def num_views(self) -> int:
        return int(self.views.shape[0])

    @property
    def spatial_shape(self) -> Shape:
        return as_shape(self.views.shape[-3:])

    @property
    def device(self) -> torch.device:
        return self.views.device

    def to(self, device) -> "MultiViewData":
        """A copy with every tensor on ``device``."""
        return MultiViewData(
            *(t.to(device) for t in (self.views, self.kernel1, self.kernel2, self.weights))
        )

    @classmethod
    def from_views(
        cls,
        views: Sequence[View],
        dtype=torch.float32,
        shape_policy: str = "strict",
        device="cuda",
    ) -> "MultiViewData":
        """Stack per-view data; kernels are center-padded to the max shape.

        ``shape_policy`` governs heterogeneous per-view image shapes:
        ``"strict"`` raises; ``"common"`` crops every image and weight
        stack to the elementwise minimum shape, anchored at the origin.
        """
        if not views:
            raise ValueError("need at least one view")
        shapes = [tuple(v.image.shape) for v in views]
        if len(set(shapes)) > 1:
            if shape_policy == "strict":
                raise ValueError(
                    "all views must share the image shape; got "
                    f"{sorted(set(shapes))}.  Pass shape_policy='common' to "
                    "deconvolve the common (min-shape) region instead."
                )
            if shape_policy != "common":
                raise ValueError(f"unknown shape_policy {shape_policy!r}")
            common = tuple(min(s[d] for s in shapes) for d in range(len(shapes[0])))
            sl = tuple(slice(0, c) for c in common)
            views = [
                View(np.asarray(v.image)[sl], v.kernel1, v.kernel2, np.asarray(v.weights)[sl])
                for v in views
            ]
        k1_shape = _max_shape([as_shape(v.kernel1.shape) for v in views])
        k2_shape = _max_shape([as_shape(v.kernel2.shape) for v in views])

        def stack(arrays):
            return torch.as_tensor(np.stack(arrays), dtype=dtype, device=device)

        return cls(
            views=stack([v.image for v in views]),
            kernel1=stack([pad_kernel_to(v.kernel1, k1_shape) for v in views]),
            kernel2=stack([pad_kernel_to(v.kernel2, k2_shape) for v in views]),
            weights=stack([v.weights for v in views]),
        )


@dataclasses.dataclass
class Workspace:
    """Algorithm knobs (``workspace``, ``inc/multiviewnative.h:28-35``).

    lambda_  : Tikhonov regularization weight (0 disables)
    min_value: clamp floor for the multiplicative update
    num_iterations: RL sweeps over all views
    """

    data: MultiViewData
    lambda_: float = 0.0
    min_value: float = 1e-4
    num_iterations: int = 1

    @classmethod
    def from_views(
        cls,
        views: Sequence[View],
        lambda_: float = 0.0,
        min_value: float = 1e-4,
        num_iterations: int = 1,
        device="cuda",
    ) -> "Workspace":
        return cls(
            data=MultiViewData.from_views(views, device=device),
            lambda_=float(lambda_),
            min_value=float(min_value),
            num_iterations=int(num_iterations),
        )


def initial_psi(data: MultiViewData, mode: str = "average") -> torch.Tensor:
    """The RL start estimate on the data's device: ``average`` (the flat
    mean of the views, the golden-data convention), ``copy`` (view 0) or
    ``ones``."""
    if mode == "average":
        return torch.full(
            data.spatial_shape, float(data.views.mean()), dtype=data.views.dtype,
            device=data.device,
        )
    if mode == "copy":
        return data.views[0].clone()
    if mode == "ones":
        return torch.ones(data.spatial_shape, dtype=data.views.dtype, device=data.device)
    raise ValueError(f"unknown initial psi mode {mode!r}")
