"""Error norms of the reference's acceptance tests (numpy only).

Counterpart of the metric half of
``libmultiviewnative_tpu/reference/oracle.py`` (the reference's
``tests/test_algorithms.hpp:87-135``), so the golden gates apply where JAX
is not installed.
"""

from __future__ import annotations

import numpy as np


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
