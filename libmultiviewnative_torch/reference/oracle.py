"""Brute-force convolution oracle and error norms (numpy only).

Counterpart of ``libmultiviewnative_tpu/reference/oracle.py`` (the
reference's ``tests/test_algorithms.hpp:9-58`` and ``:87-151``), so the
golden gates apply where JAX is not installed.
"""

from __future__ import annotations

import numpy as np


def direct_convolve(image: np.ndarray, kernel: np.ndarray, boundary: str = "zero") -> np.ndarray:
    """out[p] = sum_j kernel[j] * image[p + c - j], c = kernel_shape // 2, in
    float64: the direct spatial sum FFT convolution is checked against.

    ``boundary``: ``"zero"`` (reads outside the image are 0) or ``"wrap"``
    (circular, what the FFT path computes on unpadded data)."""
    image = np.asarray(image, np.float64)
    kernel = np.asarray(kernel, np.float64)
    if boundary not in ("zero", "wrap"):
        raise ValueError(f"unknown boundary {boundary!r}")
    out = np.zeros_like(image)
    c = tuple(k // 2 for k in kernel.shape)
    for idx in np.ndindex(*kernel.shape):
        w = kernel[idx]
        if w == 0.0:
            continue
        shift = tuple(ci - i for ci, i in zip(c, idx))  # out[p] += w * image[p + shift]
        if boundary == "wrap":
            out += w * np.roll(image, [-s for s in shift], axis=tuple(range(image.ndim)))
            continue
        if any(abs(s) >= n for s, n in zip(shift, image.shape)):
            continue
        src = tuple(slice(s, n) if s >= 0 else slice(0, n + s) for s, n in zip(shift, image.shape))
        dst = tuple(slice(0, n - s) if s >= 0 else slice(-s, n) for s, n in zip(shift, image.shape))
        out[dst] += w * image[src]
    return out


def l2norm(a: np.ndarray, b: np.ndarray) -> float:
    """sum((a-b)^2): the reference's "l2norm" is the raw sum of squared
    differences, no sqrt and no 1/N."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum((a - b) ** 2))


def _central(shape, lower_frac: float, upper_frac: float):
    return tuple(slice(int(lower_frac * n), int(upper_frac * n)) for n in shape)


def l2norm_within_limits(
    a: np.ndarray, b: np.ndarray, lower_frac: float = 0.3, upper_frac: float = 0.7
) -> float:
    """Raw sum of squared diffs over the central crop [lower_frac,
    upper_frac) per axis."""
    sl = _central(np.shape(a), lower_frac, upper_frac)
    return l2norm(np.asarray(a)[sl], np.asarray(b)[sl])


def rms(a: np.ndarray, b: np.ndarray) -> float:
    """sqrt(mean((a-b)^2)), the volume-independent error measure."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rms_within_limits(
    a: np.ndarray, b: np.ndarray, lower_frac: float = 0.3, upper_frac: float = 0.7
) -> float:
    """RMS over the central crop [lower_frac, upper_frac) per axis."""
    sl = _central(np.shape(a), lower_frac, upper_frac)
    return rms(np.asarray(a)[sl], np.asarray(b)[sl])


def l1norm(a: np.ndarray, b: np.ndarray) -> float:
    """mean(|a-b|), the reference's l1norm."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum(np.abs(a - b)) / a.size)
