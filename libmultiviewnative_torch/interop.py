"""State carried across from the JAX package as numpy arrays.

The system has no model weights: its state is the multi-view data and the
forwarded kernel spectra.  These functions take the numpy arrays of a JAX
``MultiViewData`` or of a JAX fft- or fused-engine ``PreparedSpectra``
(``np.asarray`` of each field) and give the port's objects, so one set of
inputs can run through both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .deconv.rl import FUSED_XMODE, PreparedSpectra
from .deconv.workspace import MultiViewData


def multiview_data_from_numpy(views, kernel1, kernel2, weights, device="cuda") -> MultiViewData:
    """A :class:`MultiViewData` from stacked float32 arrays: views and
    weights (V, Z, Y, X) (weights may be (V,)), kernels (V, kz, ky, kx)."""

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return MultiViewData(tensor(views), tensor(kernel1), tensor(kernel2), tensor(weights))


def prepared_from_jax(
    algorithm: str, spatial: Sequence[int], k1, k2, device="cuda", xmode: str = FUSED_XMODE
) -> PreparedSpectra:
    """A :class:`PreparedSpectra` from the spectra of a JAX ``PreparedSpectra``.

    ``"fft"``: complex64 (V, Z, Y, X//2+1) stacks.  ``"fused"``: (re, im)
    pairs of float32 (V, Kxp, Z, Y) stacks, with the JAX object's ``xmode``;
    only the dense 'standard' x-row layout is ported, so 'splitx' spectra are
    refused.  JAX materialises the adjoint's conjugate spectrum, so ``k2`` is
    used as given."""
    if algorithm == "fft":

        def tensor(a):
            return torch.tensor(np.asarray(a, np.complex64), device=device)

        return PreparedSpectra(algorithm, spatial, tensor(k1), tensor(k2))
    if algorithm == "fused":
        if xmode != FUSED_XMODE:
            raise NotImplementedError(
                f"fused spectra in the {xmode!r} x-row layout have no port yet "
                f"(ROADMAP queue 1, P7); only {FUSED_XMODE!r}"
            )

        def pair(k):
            return tuple(torch.tensor(np.asarray(a, np.float32), device=device) for a in k)

        return PreparedSpectra(algorithm, spatial, pair(k1), pair(k2), xmode=xmode)
    raise NotImplementedError(
        f"prepared spectra of the {algorithm!r} engine have no port yet; only 'fft' and 'fused'"
    )
