"""State carried across from the JAX package as numpy arrays.

The system has no model weights: its state is the multi-view data and the
forwarded kernel spectra.  These functions take the numpy arrays of a JAX
``MultiViewData`` or of a JAX fft-, dft- or fused-engine ``PreparedSpectra``
(``np.asarray`` of each field) and give the port's objects, so one set of
inputs can run through both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .deconv.rl import FUSED_XMODE, PreparedSpectra
from .deconv.workspace import MultiViewData
from .ops.fused_plan import make_fused_plan, split_perm


def multiview_data_from_numpy(views, kernel1, kernel2, weights, device="cuda") -> MultiViewData:
    """A :class:`MultiViewData` from stacked float32 arrays: views and
    weights (V, Z, Y, X) (weights may be (V,)), kernels (V, kz, ky, kx)."""

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return MultiViewData(tensor(views), tensor(kernel1), tensor(kernel2), tensor(weights))


def splitx_rows(X: int) -> tuple:
    """Where each standard x-frequency row of a fused spectrum sits in the
    JAX package's split-x layout (``fused_dft2.py:227-300``): (row, conj)
    for k = 0..X//2.  Split-x factors X = 4M and stores its rows as blocks
    [b0 | b1 | b2] at offsets 0, pad0 and pad0 + M (pad0 = M/2 + 1 rounded
    up to 8): b0 holds k = 4p (p <= M/2), b2 k = 4p + 2 (p < M/2), and b1
    k = 4p + 1 for p < M; for p >= M/2 that frequency is past X/2, so b1's
    row p carries the conjugate of k = X - 4p - 1 (k = 3 mod 4), which
    :func:`prepared_from_jax` reads with its z and y frequencies negated."""
    M, h = X // 4, X // 8
    pad0 = -(-(h + 1) // 8) * 8
    rows = []
    for k in range(X // 2 + 1):
        q, p = k % 4, k // 4
        if q == 0:
            rows.append((p, False))
        elif q == 1:
            rows.append((pad0 + p, False))
        elif q == 2:
            rows.append((pad0 + M + p, False))
        else:
            rows.append((pad0 + (X - 1 - k) // 4, True))
    return tuple(rows)


def _splitx_to_standard(re: np.ndarray, im: np.ndarray, spatial):
    """(V, Kxp, Z, Y) split-x spectra in the standard row order, pad rows
    zero.  A conjugated row is read at the negated z and y frequencies: a
    real kernel's spectrum has S(-f) = conj S(f)."""
    Z, Y, X = spatial
    plan = make_fused_plan(spatial)
    neg = []
    for n, split in ((Z, plan.split_z), (Y, plan.split_y)):
        freq = split_perm(n, split)  # position -> frequency
        at = np.empty(n, np.int64)
        at[freq] = np.arange(n)  # frequency -> position
        neg.append(at[(-freq) % n])
    out_re, out_im = np.zeros_like(re), np.zeros_like(im)
    for k, (row, conj) in enumerate(splitx_rows(X)):
        if conj:
            out_re[:, k] = re[:, row][:, neg[0]][:, :, neg[1]]
            out_im[:, k] = -im[:, row][:, neg[0]][:, :, neg[1]]
        else:
            out_re[:, k], out_im[:, k] = re[:, row], im[:, row]
    return out_re, out_im


def prepared_from_jax(
    algorithm: str, spatial: Sequence[int], k1, k2, device="cuda", xmode: str = FUSED_XMODE
) -> PreparedSpectra:
    """A :class:`PreparedSpectra` from the spectra of a JAX ``PreparedSpectra``.

    ``"fft"``: complex64 (V, Z, Y, X//2+1) stacks.  ``"dft"``: (re, im)
    pairs of float32 stacks in the dft3 layout, compact (X//2+1 wide) or
    full (``FullDFTPlan``, any axis over 256).  ``"fused"``: (re, im) pairs
    of (V, Kxp, Z, Y) stacks with the JAX object's ``xmode``; 'splitx'
    spectra are moved into the port's 'standard' row order
    (:func:`splitx_rows`).  A fused stack JAX stored in bf16
    (``LMVN_FUSED_SPEC_BF16=1``; numpy sees ``ml_dtypes.bfloat16``) stays
    bf16: it goes through float32 to ``torch.bfloat16``, both steps exact,
    so the port reads the values JAX read.  JAX materialises the adjoint's
    conjugate spectrum, so ``k2`` is used as given."""
    spatial = tuple(int(s) for s in spatial)

    def pair(k):
        return tuple(torch.tensor(np.asarray(a, np.float32), device=device) for a in k)

    if algorithm == "fft":

        def tensor(a):
            return torch.tensor(np.asarray(a, np.complex64), device=device)

        return PreparedSpectra(algorithm, spatial, tensor(k1), tensor(k2))
    if algorithm == "dft":
        return PreparedSpectra(algorithm, spatial, pair(k1), pair(k2))
    if algorithm == "fused":
        if xmode not in ("splitx", FUSED_XMODE):
            raise ValueError(f"unknown fused x-row layout {xmode!r}")

        def fused_pair(k):
            dtypes = [torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16" else torch.float32
                      for a in k]
            k = [np.asarray(a, np.float32) for a in k]
            if xmode == "splitx":
                k = _splitx_to_standard(*k, spatial)  # moves and negates: exact
            return tuple(torch.tensor(a, device=device).to(d) for a, d in zip(k, dtypes))

        return PreparedSpectra(algorithm, spatial, fused_pair(k1), fused_pair(k2),
                               xmode=FUSED_XMODE)
    raise ValueError(f"prepared spectra of the {algorithm!r} engine do not exist")
