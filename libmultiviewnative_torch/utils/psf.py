"""PSF utilities: adjoint kernels and Preibisch-style compound kernels.

Counterpart of ``libmultiviewnative_tpu/utils/psf.py``, in numpy as there,
on the port's own ``reference.numpy_ref``, ``core.shapes`` and
``deconv.workspace``.

The reference consumes ``kernel2`` ("conditional pdf of all views for view
v", tests/tiff_fixtures.hpp:21-24) as an INPUT precomputed
by the Java plugin — the library never derives it.  For a self-contained
framework we provide the derivations, following the Bayesian multi-view
model of Preibisch et al., "Efficient Bayesian-based multiview
deconvolution" (arXiv:1308.0730) and the Fiji plugin's kernel2
construction (SPIM registration, ``LRFFT.init``/``PSFTYPE``):

Notation: ``(*)`` circular-free convolution, ``(.)`` POINTWISE product of
same-support kernel images, ``P^adj(x) = P(-x)``.

  * ``independent`` (alias ``adjoint``): plain per-view RL —
        kernel2_v = P_v^adj
  * Virtual views: a photon observed at x_v in view v would have been
    observed at x_w in view w with conditional pdf (flat prior)

        p(x_w | x_v) ∝ ∫ P_v(x_v − ξ) P_w(x_w − ξ) dξ
                     = (P_v^adj (*) P_w)(x_w − x_v),

    the cross-correlation of the two PSFs.  Observing only view v, view
    w's RL factor can be emulated by blurring view v's ratio with that
    conditional pdf and applying w's own adjoint correction, giving the
    per-virtual-view factor  P_v^adj (*) P_w (*) P_w^adj.  The plugin
    folds the per-view multiplicative update factors into ONE kernel per
    view by POINTWISE-multiplying the factor kernels (conditioning: each
    factor reweights where the same photon can originate; the pointwise
    product of the conditional pdfs narrows the compound — this is what
    makes the compound modes converge FASTER per iteration, the paper's
    headline result):

      ``efficient_bayesian``:
          kernel2_v = norm( P_v^adj (.) PROD_{w != v} [P_v^adj (*) P_w (*) P_w^adj] )
      ``optimization_i``  (drop each virtual view's trailing adjoint
          correction — factors sharpen, convergence accelerates):
          kernel2_v = norm( P_v^adj (.) PROD_{w != v} [P_v^adj (*) P_w] )
      ``optimization_ii`` (assume all views share view v's PSF, so every
          factor collapses to P_v^adj itself — the plugin's
          ``computeExponentialKernel``: the pointwise numViews-th power):
          kernel2_v = norm( (P_v^adj)^(.V) )

    PROD is the pointwise product; norm() is L1 renormalization (the
    compounds stay probability kernels).  Per-iteration convergence speed
    orders  independent < efficient_bayesian < optimization_i <
    optimization_ii  (asserted on synthetic data in tests/test_psf.py).

Derived from first principles + the plugin's published construction; for
bit-parity with a specific Fiji version pass the plugin's own kernel2
files — the deconvolve path consumes kernel2 unchanged, which is the
reference library's actual contract.

Convolution-space factor compositions are computed as spectral products
on a support large enough that nothing wraps, then center-cropped to the
common output support before the pointwise product.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.shapes import as_shape


def flip_adjoint(psf: np.ndarray) -> np.ndarray:
    """P^adj — mirror through the center: P^adj(x) = P(-x)."""
    return np.flip(np.asarray(psf)).copy()


def normalize_l1(psf: np.ndarray) -> np.ndarray:
    psf = np.asarray(psf, np.float64)
    s = psf.sum()
    if s <= 0:
        raise ValueError("PSF has non-positive mass")
    return psf / s


def _spectral_compose(kernels: Sequence[np.ndarray], support) -> np.ndarray:
    """Convolve a list of kernels with each other: product of centered
    spectra on ``support`` (large enough that nothing wraps)."""
    from ..reference.numpy_ref import np_wrap_kernel

    support = as_shape(support)
    acc = None
    for k in kernels:
        spec = np.fft.rfftn(np_wrap_kernel(np.asarray(k, np.float64), support))
        acc = spec if acc is None else acc * spec
    out = np.fft.irfftn(acc, s=support, axes=tuple(range(len(support))))
    # composition is centered at the origin (wrapped); unwrap to center
    return np.fft.fftshift(out)


def _center_crop(vol: np.ndarray, shape) -> np.ndarray:
    shape = as_shape(shape)
    # keep the center voxel (index n//2) at out index s//2
    start = tuple((n // 2) - (s // 2) for n, s in zip(vol.shape, shape))
    sl = tuple(slice(st, st + s) for st, s in zip(start, shape))
    return vol[sl]


_COMPOUND_MODES = (
    "independent",
    "adjoint",  # alias of independent
    "efficient_bayesian",
    "efficient",  # legacy alias of efficient_bayesian
    "optimization_i",
    "optimization_ii",
)


def _pad_center(k: np.ndarray, shape) -> np.ndarray:
    """Center-embed a kernel into ``shape`` (kernel center -> shape//2)."""
    shape = as_shape(shape)
    out = np.zeros(shape, np.float64)
    start = tuple((s // 2) - (n // 2) for n, s in zip(k.shape, shape))
    sl = tuple(slice(st, st + n) for st, n in zip(start, k.shape))
    out[sl] = k
    return out


def _conv_factor(kernels: Sequence[np.ndarray], support) -> np.ndarray:
    """One virtual-view factor: convolve ``kernels`` together on a
    no-wrap support, center-crop to ``support``, clip spectral ringing."""
    n = len(kernels)
    max_s = tuple(max(int(k.shape[d]) for k in kernels) for d in range(3))
    full = tuple(max(n * (s - 1) + 1, o) for s, o in zip(max_s, as_shape(support)))
    comp = _spectral_compose(kernels, full)
    return np.clip(_center_crop(comp, support), 0.0, None)


def compound_kernels(
    psfs: Sequence[np.ndarray],
    mode: str = "adjoint",
    output_shape: Optional[Tuple[int, int, int]] = None,
) -> List[np.ndarray]:
    """Derive kernel2 for every view from the per-view PSFs (kernel1).

    ``mode``: 'independent'/'adjoint' (plain RL), 'efficient_bayesian'
    (alias 'efficient'), 'optimization_i', 'optimization_ii' — see module
    docstring for the formulas and their provenance.

    ``output_shape`` defaults to each PSF's own support for the adjoint
    modes and the common max support for compound modes (the pointwise
    product needs one support; the reference's data uses 25^3 kernel2 for
    21^3 kernel1 — a slightly enlarged truncated support is fine too).
    """
    if mode not in _COMPOUND_MODES:
        raise ValueError(
            f"unknown compound mode {mode!r}; expected one of {_COMPOUND_MODES}"
        )
    psfs = [normalize_l1(p) for p in psfs]
    if mode in ("adjoint", "independent"):
        outs = [flip_adjoint(p) for p in psfs]
        if output_shape is not None:
            from ..deconv.workspace import pad_kernel_to

            outs = [pad_kernel_to(o, output_shape) for o in outs]
        return [o.astype(np.float32) for o in outs]

    if mode == "efficient":
        mode = "efficient_bayesian"

    V = len(psfs)
    max_support = tuple(
        max(int(p.shape[d]) for p in psfs) for d in range(3)
    )
    if output_shape is None:
        output_shape = max_support
    outs = []
    for v, pv in enumerate(psfs):
        adj_v = flip_adjoint(pv)
        if mode == "optimization_ii":
            # pointwise numViews-th power of the adjoint PSF
            # (plugin: computeExponentialKernel + invert)
            comp = _pad_center(adj_v, output_shape) ** V
        else:
            comp = _pad_center(adj_v, output_shape)
            for w, pw in enumerate(psfs):
                if w == v:
                    continue
                if mode == "efficient_bayesian":
                    factor = _conv_factor(
                        [adj_v, pw, flip_adjoint(pw)], output_shape
                    )
                else:  # optimization_i
                    factor = _conv_factor([adj_v, pw], output_shape)
                comp = comp * factor
        outs.append(normalize_l1(comp).astype(np.float32))
    return outs
