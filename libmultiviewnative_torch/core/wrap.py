"""Kernel wrapping and image embedding on tensors.

Counterpart of ``libmultiviewnative_tpu/core/wrap.py``; replaces the
reference's element loops (``wrapped_insert_at_point``,
``inc/padd_utils.h:11-40``; ``zero_padd::insert_at_offsets``, :179-194).

Semantics (bit-for-bit vs the reference):
  wrapped target[(i - k//2) mod extents] = kernel[i]
i.e. the kernel's center voxel lands at index 0 of the target and the
"negative" half wraps to the far end, so FFT convolution adds no shift.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .shapes import as_shape, kernel_center


def _pad_hi(x: torch.Tensor, hi: Sequence[int]) -> torch.Tensor:
    """Zero-pad the high end of every axis by ``hi`` (F.pad lists the last
    axis first)."""
    pad = []
    for h in reversed(as_shape(hi)):
        pad += [0, h]
    return F.pad(x, pad)


def wrap_kernel(kernel: torch.Tensor, extents: Sequence[int]) -> torch.Tensor:
    """Embed ``kernel`` into a zeros(extents) buffer with its center at origin.

    Place the kernel at the low corner, then roll by -center on every axis.
    A kernel larger than the extent aliases under circular convolution,
    target[(i - c) mod e] += kernel[i]: each axis is padded up to a multiple
    of its extent and the period blocks are summed.
    """
    extents = as_shape(extents)
    kshape = as_shape(kernel.shape)
    if len(extents) != kernel.ndim:
        raise ValueError(f"rank mismatch: kernel {kshape} vs extents {extents}")
    if any(e < k for e, k in zip(extents, kshape)):
        buf = _pad_hi(kernel, [-k % e for e, k in zip(extents, kshape)])
        folded_shape = []
        for e, p in zip(extents, buf.shape):
            folded_shape.extend((p // e, e))
        buf = buf.reshape(folded_shape).sum(dim=tuple(range(0, 2 * kernel.ndim, 2)))
    else:
        buf = _pad_hi(kernel, [e - k for e, k in zip(extents, kshape)])
    shifts = tuple(-(c % e) for c, e in zip(kernel_center(kshape), extents))
    return torch.roll(buf, shifts, dims=tuple(range(kernel.ndim)))


def embed_at_offsets(
    image: torch.Tensor, extents: Sequence[int], offsets: Sequence[int]
) -> torch.Tensor:
    """Zero-embed ``image`` into an extents-sized buffer at ``offsets``
    (``zero_padd::insert_at_offsets``, ``inc/padd_utils.h:179-194``)."""
    extents, offsets = as_shape(extents), as_shape(offsets)
    pad = [(o, e - o - s) for o, e, s in zip(offsets, extents, image.shape)]
    for d, (lo, hi) in enumerate(pad):
        if lo < 0 or hi < 0:
            raise ValueError(
                f"image {tuple(image.shape)} + offsets {offsets} exceeds "
                f"extents {extents} along axis {d}"
            )
    flat = []
    for lo, hi in reversed(pad):
        flat += [lo, hi]
    return F.pad(image, flat)


def crop_at_offsets(
    padded: torch.Tensor, shape: Sequence[int], offsets: Sequence[int]
) -> torch.Tensor:
    """Crop the ROI back out of the padded buffer (a view, not a copy)."""
    shape, offsets = as_shape(shape), as_shape(offsets)
    return padded[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]
