"""The least time of a cell's work: one count for any implementation.

The count depends on the configuration and the traffic alone, never on the
engine or its kernels, so a change that merges, splits or replaces kernels
cannot make it stale.  Each RL view step on N = Z·Y·X voxels reads psi, the
view and (per voxel) the weights, writes psi, and reads the kernel
half-spectra (two, or one under the adjoint, each 8·Z·Y·(X/2+1) bytes); it
takes four real 3-D FFTs of 2.5·N·log2(N) operations.  Each call also
writes the spectra it forwards.  In a batch the shared weights and spectra
are read once for each batched view step.  The least time is the larger of
the bytes over the HBM bandwidth and the operations over the fp32 rate:
a bound no implementation of the same float32 arithmetic can beat.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, data sheet: HBM3 bandwidth and fp32 rate outside the
# tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


def call_work(cfg: dict, batch: int) -> dict:
    """Bytes and operations of one call on ``batch`` volumes."""
    Z, Y, X = cfg["shape"]
    n = Z * Y * X
    half = Z * Y * (X // 2 + 1)
    spectra = 1 if cfg["adjoint_kernel2"] else 2
    per_voxel = cfg["weights"] == "per_voxel"
    step_bytes = batch * 3 * 4 * n + (4 * n if per_voxel else 0) + spectra * 8 * half
    step_flops = batch * 4 * 2.5 * n * math.log2(n)
    steps = cfg["views"] * cfg["iterations"]
    forwarded = cfg["views"] * spectra * 8 * half
    return {"bytes": steps * step_bytes + forwarded, "flops": steps * step_flops,
            "view_steps": steps, "step_bytes": step_bytes, "step_flops": step_flops,
            "forwarded_bytes": forwarded}


def least_seconds(work: dict) -> float:
    """The least time of ``work``: the larger of its two bounds."""
    return max(work["bytes"] / PEAK_BYTES_PER_S, work["flops"] / PEAK_FLOPS)


def bound_by(work: dict) -> str:
    """Which bound sets the least time: ``bytes`` or ``flops``."""
    return "bytes" if work["bytes"] / PEAK_BYTES_PER_S >= work["flops"] / PEAK_FLOPS else "flops"


def share(least_s: float, measured_s: float):
    """``least_s`` as a share of a measured time, or None where nothing was
    measured.  It cannot exceed 1 where the measured time is at least the
    least time."""
    if measured_s <= 0.0:
        return None
    return least_s / measured_s
