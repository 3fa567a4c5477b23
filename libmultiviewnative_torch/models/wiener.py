"""Multi-view Wiener deconvolution: one closed-form spectral solve.

Counterpart of ``libmultiviewnative_tpu/models/wiener.py``:

    psi_hat = sum_v conj(K_v) * Phi_v  /  (sum_v |K_v|^2 + nsr)

with nsr the noise-to-signal floor, in the RL path's wrapped-kernel
convention (``inc/padd_utils.h:11-40`` centring), through ``torch.fft`` as
the JAX one goes through ``jnp.fft``.  A fast preview or an RL initialiser.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.fft import irfft3, rfft3
from ..core.wrap import wrap_kernel
from ..deconv.workspace import MultiViewData


@dataclasses.dataclass
class WienerFilter:
    nsr: float = 1e-3  # noise-to-signal ratio (Tikhonov-style floor)
    clip_min: float = 0.0  # clamp negatives (intensities are non-negative)

    def run(self, data: MultiViewData) -> torch.Tensor:
        return wiener_deconvolve(data, self.nsr, self.clip_min)


def wiener_deconvolve(data: MultiViewData, nsr: float = 1e-3, clip_min: float = 0.0) -> torch.Tensor:
    """One-shot multi-view Wiener estimate from the stacked views, where the
    data lives."""
    spatial = tuple(data.views.shape[-3:])
    k_hat = rfft3(torch.stack([wrap_kernel(k.to(torch.float32), spatial) for k in data.kernel1]))
    v_hat = rfft3(data.views)
    num = torch.sum(k_hat.conj() * v_hat, dim=0)
    den = torch.sum(k_hat.abs() ** 2, dim=0) + nsr
    return torch.clamp(irfft3(num / den, spatial), min=clip_min)
