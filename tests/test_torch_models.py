"""The port's models (RichardsonLucy, WienerFilter) against the JAX
package's, on tests/test_models.py's problem: a bead phantom at 20³ blurred
by 3 Gaussian 7³ PSFs in float64.

Tolerance: 1e-5 of max|JAX|.  RichardsonLucy through ``deconvolve_auto``
takes the in-core rung and, at 20³ on the CPU, the dft engine in both
packages; WienerFilter is one rfft solve.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData, Workspace as JaxWs
from libmultiviewnative_tpu.models import RichardsonLucy as JaxRL, WienerFilter as JaxWiener
from libmultiviewnative_tpu.reference.numpy_ref import np_convolve_spectrum, np_wrap_kernel
from libmultiviewnative_torch import RichardsonLucy, WienerFilter, deconvolve_auto
from libmultiviewnative_torch.deconv.workspace import View, Workspace, initial_psi
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (20, 20, 20)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(17)
    phantom = np.full(SHAPE, 1.0)
    for _ in range(6):
        z, y, x = (rng.integers(4, s - 4) for s in SHAPE)
        phantom[z, y, x] = 300.0
    V = 3
    k1 = np.stack([gaussian_kernel((7, 7, 7), 1.0 + 0.3 * v) for v in range(V)])
    views = np.stack([
        np_convolve_spectrum(phantom, np.fft.rfftn(np_wrap_kernel(k, SHAPE))) for k in k1
    ]).astype(np.float32)
    arrays = (views, k1, np.flip(k1, axis=(1, 2, 3)).copy(), np.full((V,) + SHAPE, 1.0 / V,
                                                                    np.float32))
    return phantom, arrays


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(num_iterations=3, lambda_=0.006),
    dict(num_iterations=3, lambda_=0.006, auto_dispatch=False, algorithm="fft"),
    dict(num_iterations=2, view_order="simultaneous", algorithm="fft"),
    dict(num_iterations=2, adjoint_kernel2=True, initial="copy"),
], ids=["auto-dispatch", "deconvolve-fft", "simultaneous", "adjoint-copy"])
def test_richardson_lucy_matches_jax(problem, kw):
    _, arrays = problem
    want = JaxRL(**kw).run(JaxData(*(jnp.asarray(a) for a in arrays)))
    data = multiview_data_from_numpy(*arrays, device="cpu")
    got = RichardsonLucy(device="cpu", **kw).run(data)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _rel(got.numpy(), want) <= TOL


def test_run_auto_is_deconvolve_auto_and_run_workspace(problem):
    _, arrays = problem
    data = multiview_data_from_numpy(*arrays, device="cpu")
    model = RichardsonLucy(num_iterations=2, lambda_=0.006, device="cpu")
    want = deconvolve_auto(initial_psi(data), data, 2, lam=0.006, device="cpu")
    torch.testing.assert_close(model.run(data), want, rtol=0, atol=0)
    views = [View(*(a[v] for a in arrays)) for v in range(3)]
    ws = Workspace.from_views(views, lambda_=0.006, num_iterations=2, device="cpu")
    jws = JaxWs.from_views(views, lambda_=0.006, num_iterations=2)
    got = RichardsonLucy(device="cpu").run_workspace(ws)
    assert _rel(got.numpy(), JaxRL().run_workspace(jws)) <= TOL


@pytest.mark.parametrize("nsr", [1e-4, 1e-3])
def test_wiener_matches_jax_and_deconvolves(problem, nsr):
    phantom, arrays = problem
    want = JaxWiener(nsr=nsr).run(JaxData(*(jnp.asarray(a) for a in arrays)))
    got = WienerFilter(nsr=nsr).run(multiview_data_from_numpy(*arrays, device="cpu"))
    assert _rel(got.numpy(), want) <= TOL
    rms = lambda a: float(np.sqrt(np.mean((a - phantom) ** 2)))
    assert rms(got.numpy()) < rms(arrays[0][0]) and float(got.min()) >= 0.0
