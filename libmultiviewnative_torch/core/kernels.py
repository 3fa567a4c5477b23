"""Elementwise Richardson-Lucy update math in plain PyTorch.

Counterpart of ``libmultiviewnative_tpu/core/kernels.py``.  These are the
plain versions of the hand-written kernels in :mod:`..ops.elementwise`
(K1 ``rl_update``, K2 ``quotient``): the CPU path runs them, and the card's
kernels are held against them.

Numerical semantics follow the reference (``inc/cpu_kernels.h:16-90``),
including the NaN/Inf clamping order.  Python-float λ and min_value enter
the arithmetic as float32 scalars, as they do in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_quotient(view: torch.Tensor, integral: torch.Tensor) -> torch.Tensor:
    """quotient = view * (1 / integral): reciprocal then multiply, the
    reference's order (``inc/cpu_kernels.h:20-26``).  Division by zero
    yields inf; the clamp in the update absorbs it."""
    return view * (1.0 / integral)


def _clamp_blend(psi, value, weights, min_value):
    nxt = torch.where(
        torch.isnan(value) | torch.isinf(value),
        min_value,
        torch.clamp_min(value, min_value),
    )
    return weights * (nxt - psi) + psi


def final_values(psi, integral, weights, min_value: float) -> torch.Tensor:
    """Plain multiplicative RL update (``inc/cpu_kernels.h:29-54``):

        value = psi * integral
        if !(value > 0): value = minValue          # catches NaN and <= 0
        if isnan(value) or isinf(value): next = minValue
        else: next = max(value, minValue)
        psi' = weight * (next - psi) + psi
    """
    min_value = float(np.float32(min_value))
    value = psi * integral
    value = torch.where(value > 0.0, value, min_value)
    return _clamp_blend(psi, value, weights, min_value)


def regularized_final_values(
    psi, integral, weights, lam, min_value: float
) -> torch.Tensor:
    """Tikhonov-regularized RL update (``inc/cpu_kernels.h:59-90``):

        value = psi * integral
        if value > 0: value = (sqrt(1 + 2*lambda*value) - 1) / lambda
        else:         value = minValue
        (then the same NaN/Inf clamp and weighted blend as final_values)

    The transform runs in float32, as ``1/λ · (sqrt(1 + (2λ)·value) − 1)``.
    ``lam`` is a Python number or a 0-dim tensor.
    """
    min_value = float(np.float32(min_value))
    value = psi * integral
    if isinstance(lam, torch.Tensor):
        lam32 = lam.to(torch.float32)
        two_lam, lam_inv = 2.0 * lam32, 1.0 / lam32
    else:
        lam32 = np.float32(lam)
        two_lam = float(np.float32(2.0) * lam32)
        lam_inv = float(np.float32(1.0) / lam32)
    tik = lam_inv * (torch.sqrt(1.0 + two_lam * value) - 1.0)
    value = torch.where(value > 0.0, tik, min_value)
    return _clamp_blend(psi, value, weights, min_value)


def rl_update(psi, integral, weights, lam, min_value) -> torch.Tensor:
    """Dispatch between plain and Tikhonov updates on λ
    (``src/multiviewnative.cpp:216-227``).

    A Python-number λ picks the branch on the host.  A tensor λ computes
    both branches and selects elementwise; the unselected Tikhonov branch
    runs with a safe λ=1 so no NaN/Inf leaks through the select, and the
    selected values equal the Python-λ program's.
    """
    if not isinstance(lam, torch.Tensor):
        if lam > 0.0:
            return regularized_final_values(psi, integral, weights, lam, min_value)
        return final_values(psi, integral, weights, min_value)
    lam = lam.to(torch.float32)
    use_tik = lam > 0.0
    safe_lam = torch.where(use_tik, lam, torch.ones_like(lam))
    reg = regularized_final_values(psi, integral, weights, safe_lam, min_value)
    plain = final_values(psi, integral, weights, min_value)
    return torch.where(use_tik, reg, plain)
