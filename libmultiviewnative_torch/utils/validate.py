"""Input validation: NaN and Inf guards.

Counterpart of ``libmultiviewnative_tpu/utils/validate.py``, after the
reference's defensive scans: ``contains_nan`` / ``contains_inf`` over the
workspace inputs (``src/multiviewnative.cpp:18-58``, applied at :129-143)
and the TIFF loader's NaN audit (``tests/tiff_fixtures.hpp:106-131``).  The
scan runs where the tensor lives, and each array costs one read back to the
host (both flags together).
"""

from __future__ import annotations

from typing import List

import torch

from ..deconv.workspace import MultiViewData


def _finite_report(x) -> List[bool]:
    t = torch.as_tensor(x)
    return torch.stack([torch.isnan(t).any(), torch.isinf(t).any()]).tolist()


def check_finite(x, name: str = "array", raise_on_bad: bool = False) -> List[str]:
    """Return human-readable problems of a tensor or array (empty list = clean)."""
    has_nan, has_inf = _finite_report(x)
    problems = []
    if has_nan:
        problems.append(f"{name} contains NaN")
    if has_inf:
        problems.append(f"{name} contains Inf")
    if raise_on_bad and problems:
        raise ValueError("; ".join(problems))
    return problems


def validate_workspace(data: MultiViewData, raise_on_bad: bool = True) -> List[str]:
    """Audit all stacked inputs: the reference runs exactly this scan on
    image/kernel1/kernel2/weights per view before iterating
    (``src/multiviewnative.cpp:129-143``)."""
    problems = []
    for name in ("views", "kernel1", "kernel2", "weights"):
        problems += check_finite(getattr(data, name), name)
    if raise_on_bad and problems:
        raise ValueError("; ".join(problems))
    return problems
