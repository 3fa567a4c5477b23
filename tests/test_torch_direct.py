"""The port's direct engine (core/convolve.py ``direct_convolve3d``, the
``convolve3d`` policy and ``algorithm="direct"``) against the JAX package's
on the same numpy inputs.

Tolerance: 1e-5 of max|JAX|.  The shift-and-add stencil adds the taps in the
JAX package's order (bitwise equal on the CPU); the conv path is
``torch.nn.functional.conv3d`` against ``lax.conv`` at HIGHEST, another
summation order (about 1e-6 of max seen at 7³).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.core import convolve as jconv
from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_torch.core import convolve
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
V = 4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


# 3³ and 7³ kernels at (16, 24, 32), an even-sized kernel, and halos longer
# than the volume's axes (a 9³ kernel on (4, 5, 6)), which the wrap gathers
@pytest.mark.parametrize("shape, kshape", [
    ((16, 24, 32), (3, 3, 3)), ((16, 24, 32), (7, 7, 7)), ((16, 24, 32), (4, 5, 6)),
    ((4, 5, 6), (9, 9, 9)),
], ids=str)
@pytest.mark.parametrize("mode", ["circular", "linear"])
def test_direct_convolve_matches_jax(shape, kshape, mode):
    rng = np.random.default_rng(3)
    x = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    k = rng.uniform(size=kshape).astype(np.float32)
    for stencil in ("rolls", "conv", "auto"):
        want = jconv.direct_convolve3d(jnp.asarray(x), jnp.asarray(k), mode=mode, stencil=stencil)
        got = convolve.direct_convolve3d(torch.from_numpy(x), torch.from_numpy(k), mode=mode,
                                         stencil=stencil)
        assert _rel(got.numpy(), want) <= TOL, stencil


def test_convolve3d_policy_and_batch():
    """``convolve3d("auto")`` takes the direct path up to 15³ taps and the
    FFT path above, as JAX's; leading axes are a batch."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.gamma(2.0, 1.0, (2, 12, 16, 20)).astype(np.float32))
    for kshape, path in (((3, 3, 3), "direct"), ((17, 3, 3), "direct"), ((17, 15, 15), "fft")):
        k = torch.from_numpy(rng.uniform(size=kshape).astype(np.float32))
        got = convolve.convolve3d(x, k)
        own = {"direct": convolve.direct_convolve3d, "fft": convolve.fft_convolve3d}[path](x, k)
        torch.testing.assert_close(got, own, rtol=0, atol=0)
        want = jconv.convolve3d(jnp.asarray(x.numpy()), jnp.asarray(k.numpy()))
        assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="unknown algorithm"):
        convolve.convolve3d(x, k, algorithm="dft")
    with pytest.raises(ValueError, match="unknown stencil"):
        convolve.direct_convolve3d(x, k, stencil="fft")


def test_conv_path_runs_without_tf32(monkeypatch):
    """The conv path runs with cuDNN's TF32 off whatever the caller set, and
    the caller's setting is back afterwards (``allow_tf32`` defaults to
    True).  chip_smoke.py phase 21 holds the values on the card."""
    from libmultiviewnative_torch.utils import precision

    cudnn = torch.backends.cudnn
    handles = precision._cudnn_tf32_handles()
    before = [h.fp32_precision for h in handles] if handles else cudnn.allow_tf32
    conv3d, seen = torch.nn.functional.conv3d, []

    def spy(*a, **k):
        seen.append([h.fp32_precision for h in handles] if handles else cudnn.allow_tf32)
        return conv3d(*a, **k)

    monkeypatch.setattr(convolve.F, "conv3d", spy)
    cudnn.allow_tf32 = True
    x = torch.rand((8, 8, 8))
    convolve.direct_convolve3d(x, torch.rand((7, 7, 7)), stencil="conv")
    assert seen == ([["ieee", "ieee"]] if handles else [False])
    assert ([h.fp32_precision for h in handles] if handles else cudnn.allow_tf32) == before
    assert cudnn.allow_tf32


def _inputs(scalar_weights=False, seed=0):
    shape = (12, 10, 9)
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 0.8 + 0.2 * v) for v in range(V)])
    k2 = np.stack([np.flip(k).copy() for k in k1])
    if scalar_weights:
        w = np.full((V,), 1.0 / V, np.float32)
    else:
        w = rng.uniform(0.5, 1.5, (V,) + shape).astype(np.float32)
        w /= w.sum(axis=0, keepdims=True)
    return np.full(shape, views.mean(), np.float32), views, k1, k2, w


@pytest.mark.parametrize(
    "kw",
    [dict(lam=0.0), dict(lam=0.006), dict(lam=0.006, view_order="simultaneous"),
     dict(lam=0.0, adjoint_kernel2=True)],
    ids=["plain", "tikhonov", "simultaneous", "adjoint"],
)
def test_deconvolve_direct_matches_jax(kw):
    psi0, views, k1, k2, w = _inputs(scalar_weights="adjoint_kernel2" in kw)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    want = jrl.deconvolve_jit(jnp.asarray(psi0), jdata, 3, algorithm="direct", **kw)
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    got = rl.deconvolve(torch.from_numpy(psi0), data, 3, algorithm="direct", **kw)
    assert _rel(got.numpy(), want) <= TOL


def test_prepare_workspace_refuses_direct():
    """The direct engine keeps its kernels spatial: nothing to prepare, as
    JAX's prepare_workspace refuses it."""
    psi0, views, k1, k2, w = _inputs()
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    with pytest.raises(ValueError, match="fft/dft/fused"):
        jrl.prepare_workspace(jdata, psi0.shape, algorithm="direct")
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    with pytest.raises(ValueError, match="fft/dft/fused"):
        rl.prepare_workspace(data, psi0.shape, algorithm="direct")
