"""Richardson-Lucy model facade.

Counterpart of ``libmultiviewnative_tpu/models/richardson_lucy.py``: the
knobs of the reference's ``workspace`` struct (``inc/multiviewnative.h:28-35``)
and the execution axes (engine, view order, dispatch rung) bound into one
configured object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..deconv.dispatch import deconvolve_auto
from ..deconv.rl import deconvolve
from ..deconv.workspace import MultiViewData, Workspace, initial_psi


@dataclasses.dataclass
class RichardsonLucy:
    """Bayesian multi-view RL (arXiv:1308.0730 Eq. 70).

    ``lambda_ > 0`` selects the Tikhonov-regularised update
    (``inc/cpu_kernels.h:59-90``).  :meth:`run` goes through
    :func:`..deconv.dispatch.deconvolve_auto` on ``device``, or straight to
    :func:`..deconv.rl.deconvolve` where the data lives with
    ``auto_dispatch=False``.  The JAX model's ``elementwise`` field has no
    counterpart: the port's drivers always run the K1 and K2 kernels."""

    num_iterations: int = 10
    lambda_: float = 0.0
    min_value: float = 1e-4
    view_order: str = "sequential"
    algorithm: str = "auto"
    auto_dispatch: bool = True
    initial: str = "average"
    adjoint_kernel2: bool = False
    device: str = "cuda"

    def run(self, data: MultiViewData, psi0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if psi0 is None:
            psi0 = initial_psi(data, self.initial)
        kw = dict(lam=self.lambda_, min_value=self.min_value, algorithm=self.algorithm,
                  adjoint_kernel2=self.adjoint_kernel2, view_order=self.view_order)
        if self.auto_dispatch:
            return deconvolve_auto(psi0, data, self.num_iterations, device=self.device, **kw)
        return deconvolve(psi0, data, self.num_iterations, **kw)

    def run_workspace(self, ws: Workspace, psi0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`run` with the workspace's iterations, λ and clamp."""
        model = dataclasses.replace(
            self, num_iterations=ws.num_iterations, lambda_=ws.lambda_, min_value=ws.min_value
        )
        return model.run(ws.data, psi0)
