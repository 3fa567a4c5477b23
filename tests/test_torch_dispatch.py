"""The port's single-device dispatch ladder (deconv/dispatch.py) and its one
``resolve_algorithm`` against the JAX package's, on tests/test_dispatch.py's
problem: 2 views at (16, 8, 8), 3³ kernels, per-voxel weights 1/V.

Each rung is forced as tests/test_dispatch.py:54-72 forces it, by
monkeypatching ``device_capacity_bytes`` (and, on the JAX side, a device
count of 1: the JAX suite runs on 8 CPU devices, where JAX would take its
mesh rungs, which the port does not have).

Tolerance: 1e-5 of max|psi| against JAX's same rung.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import dispatch as jdispatch
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_torch.deconv import dispatch, rl, streamed
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (16, 8, 8)
V = 2


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (V,) + SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((V,) + SHAPE, 1.0 / V, np.float32)
    return views, k1, k2, w


def _both(arrays):
    jdata = JaxData(*(jnp.asarray(a) for a in arrays))
    data = multiview_data_from_numpy(*arrays, device="cpu")
    psi0 = np.full(SHAPE, float(arrays[0].mean()), np.float32)
    return jdata, data, psi0


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _capacity(monkeypatch, nbytes):
    """Both packages believe the device holds ``nbytes``; JAX counts one
    device."""
    monkeypatch.setattr(jdispatch, "device_capacity_bytes", lambda device=None: nbytes)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: nbytes)


# tests/test_dispatch.py:297-317's shapes, on the CPU backend
@pytest.mark.parametrize("algorithm, shape", [
    ("auto", (256, 256, 256)), ("dft", (512, 512, 512)), ("auto", (512, 512, 512)),
    ("auto", (128, 128, 128)), ("auto", (300, 512, 512)), ("auto", (512, 512, 511)),
    ("auto", (16, 8, 8)), ("auto", (257, 8, 8)), ("fused", (16, 24, 32)),
], ids=str)
def test_resolve_algorithm_matches_jax_on_the_cpu(algorithm, shape):
    want = jdispatch.resolve_algorithm(algorithm, shape)
    assert rl.resolve_algorithm(algorithm, shape, "cpu") == want
    assert rl.resolve_algorithm(algorithm, shape, "cpu", chunk=True) == want
    with pytest.raises(ValueError, match="unknown algorithm"):
        rl.resolve_algorithm("dtf", shape, "cpu")


# the CUDA table (PERF.md §6; chip_smoke.py phase 22 on an H100): fused
# where every axis is at least 256 and the CUDA passes serve the shape, else
# fft, never dft; a streamed chunk is never fused
CUDA_TABLE = [
    ((64, 64, 64), "fft", "fft"),
    ((128, 128, 128), "fft", "fft"),
    ((256, 256, 256), "fused", "fft"),
    ((512, 512, 512), "fused", "fft"),
    ((32, 512, 512), "fft", "fft"),
    ((300, 512, 512), "fft", "fft"),
    ((1024, 512, 512), "fft", "fft"),
]


@pytest.mark.parametrize("shape, incore, chunk", CUDA_TABLE, ids=str)
def test_resolve_algorithm_cuda_table(monkeypatch, shape, incore, chunk):
    """Pinned on the CPU: the device defaults to the card when one is there
    (the check monkeypatched), and an explicit CUDA device needs no card."""
    assert rl.resolve_algorithm("auto", shape, "cuda") == incore
    assert rl.resolve_algorithm("auto", shape, "cuda", chunk=True) == chunk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert rl.resolve_algorithm("auto", shape) == incore


@pytest.mark.parametrize("algorithm", ["fft", "dft", "fused", "direct", "auto"])
def test_estimates_match_jax(algorithm):
    jdata, data, _ = _both(_arrays())
    assert dispatch.estimate_workspace_bytes(data, algorithm, "cpu") == \
        jdispatch.estimate_workspace_bytes(jdata, algorithm)
    assert dispatch.estimate_interleaved_bytes(data, algorithm, "cpu") == \
        jdispatch.estimate_interleaved_bytes(jdata, algorithm)
    assert dispatch.device_capacity_bytes("cpu") == 16 * 1024**3


def _rung_cap(data, rung, algorithm):
    est = dispatch.estimate_workspace_bytes(data, algorithm, "cpu")
    est_il = dispatch.estimate_interleaved_bytes(data, algorithm, "cpu")
    assert est_il < est
    return {"in-core": 16 * 1024**3, "interleaved": int((est_il + est) / 2 / 0.9) + 1,
            "streamed": 1}[rung]


@pytest.mark.parametrize("rung", ["in-core", "interleaved", "streamed"])
@pytest.mark.parametrize("algorithm", ["auto", "fft", "dft"])
def test_each_rung_matches_jax(monkeypatch, capsys, rung, algorithm):
    jdata, data, psi0 = _both(_arrays())
    _capacity(monkeypatch, _rung_cap(data, rung, algorithm))
    monkeypatch.setenv("LMVN_TRACE", "1")
    kw = dict(lam=0.006, algorithm=algorithm, chunk_z=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, device="cpu", **kw)
    assert f"dispatch: {rung} on one device" in capsys.readouterr().out
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, **kw)
    assert _rel(got.numpy(), want) <= TOL


def test_streamed_rung_honours_adjoint_kernel2(monkeypatch):
    """A poisoned kernel2 stays ignored when the ladder falls to the
    streamed rung (tests/test_dispatch.py:242-270)."""
    views, k1, _, w = _arrays()
    poisoned = np.ones_like(k1) / k1[0].size
    jdata, data, psi0 = _both((views, k1, poisoned, w))
    _capacity(monkeypatch, 1)
    kw = dict(adjoint_kernel2=True, chunk_z=8, algorithm="fft")
    got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, device="cpu", **kw)
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, **kw)
    assert _rel(got.numpy(), want) <= TOL
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, adjoint_kernel2=True, algorithm="fft")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="odd kernel1 dims"):
        dispatch.deconvolve_auto(torch.from_numpy(psi0), multiview_data_from_numpy(
            views, np.zeros((V, 4, 3, 3), np.float32), poisoned, w, device="cpu"), 1,
            adjoint_kernel2=True, device="cpu")


def test_divergence_and_strict(monkeypatch):
    """An engine or view order a rung cannot honour warns (JAX's
    DispatchDivergenceWarning contract) or, with ``strict``, raises; an
    explicit fused request on the interleaved rung passes silently."""
    jdata, data, psi0 = _both(_arrays())
    psi = torch.from_numpy(psi0)
    _capacity(monkeypatch, 1)
    with pytest.warns(dispatch.DispatchDivergenceWarning, match="streamed rung"):
        got = dispatch.deconvolve_auto(psi, data, 2, algorithm="fused", chunk_z=8, device="cpu")
    with pytest.warns(jdispatch.DispatchDivergenceWarning):
        want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, algorithm="fused", chunk_z=8)
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        dispatch.deconvolve_auto(psi, data, 1, view_order="simultaneous", strict=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 1, view_order="simultaneous",
                                  strict=True)
    _capacity(monkeypatch, _rung_cap(data, "interleaved", "fused"))
    with pytest.raises(ValueError, match="interleaved rung"):
        dispatch.deconvolve_auto(psi, data, 1, algorithm="fused", view_order="simultaneous",
                                 strict=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(psi, data, 2, algorithm="fused", chunk_z=8, device="cpu")
    incore = rl.deconvolve(psi, data, 2, algorithm="fused")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=2e-5, atol=2e-4)


def test_direct_request_skips_the_interleaved_rung(monkeypatch):
    """The interleaved rung is skipped for an explicit "direct" request,
    which the streamed rung honours (its chunks run the direct engine)."""
    _, data, psi0 = _both(_arrays())
    _capacity(monkeypatch, _rung_cap(data, "interleaved", "direct"))
    seen = []
    monkeypatch.setattr(dispatch, "deconvolve_interleaved",
                        lambda *a, **k: seen.append("interleaved"))
    real = streamed._convolver
    monkeypatch.setattr(streamed, "_convolver",
                        lambda *a: seen.append(a[2]) or real(*a))
    got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 1, algorithm="direct",
                                   chunk_z=8, device="cpu")
    assert seen and set(seen) == {"direct"}
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 1, algorithm="direct")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)
