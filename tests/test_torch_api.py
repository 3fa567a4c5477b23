"""The port's flat API (``api.py``) and the bridge's wire format
(``native_entry.py``) against the JAX package's, on the same numpy inputs.

Tolerances: ``deconvolve_flat`` within 1e-4 of max|psi| after 2 iterations
(the RTOL of test_torch_rl.py: the port's fft engine and XLA's FFTs round
apart); ``quotient_flat`` and ``final_values_flat`` at λ = 0 bitwise (the
same float32 operations in the same order); the Tikhonov update within 2e-4
relative (PyTorch's CPU ``sqrt`` is an ulp off on some inputs near 1, and
the step amplifies that to about ulp(1)/λ); ``convolution3d`` and the view
steps within 1e-5 of max.
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu import api as japi
from libmultiviewnative_torch import api, native_entry
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-4
STEP_TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _views(num, shape, seed, hetero):
    rng = np.random.default_rng(seed)
    imgs = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(num)]
    k1s = [gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(num)]
    if hetero:
        k1s[1] = gaussian_kernel((3, 5, 3), 0.8)  # smaller than view 0's 5³
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [rng.uniform(0.2, 0.6, shape).astype(np.float32) for _ in range(num)]
    return imgs, k1s, k2s, ws


@pytest.mark.parametrize("hetero", [False, True], ids=["same-kernels", "hetero-kernels"])
@pytest.mark.parametrize("shape", [(12, 12, 12), (24, 24, 24)], ids=["12", "24"])
def test_deconvolve_flat_matches_jax(shape, hetero):
    imgs, k1s, k2s, ws = _views(2, shape, 9, hetero)
    psi0 = np.full(shape, float(np.mean(imgs)), np.float32)
    want = japi.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.006)
    got = api.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.006,
                              device="cpu")
    assert _rel(got, want) <= RTOL


def test_single_step_helpers_match_jax():
    rng = np.random.default_rng(3)
    shape = (6, 5, 7)
    a = rng.gamma(2.0, 5.0, shape).astype(np.float32)
    b = rng.uniform(-0.2, 2.0, shape).astype(np.float32)  # some <= 0: the clamp path
    b[0, 0, :2] = 0.0  # 1/0: inf, then the clamp
    w = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    np.testing.assert_array_equal(api.quotient_flat(a, b, device="cpu"), japi.quotient_flat(a, b))
    np.testing.assert_array_equal(
        api.final_values_flat(a, b, w, lambda_=0.0, device="cpu"),
        japi.final_values_flat(a, b, w, lambda_=0.0),
    )
    np.testing.assert_allclose(
        api.final_values_flat(a, b, w, lambda_=0.006, device="cpu"),
        japi.final_values_flat(a, b, w, lambda_=0.006), rtol=2e-4,
    )


@pytest.mark.parametrize("mode", ["circular", "linear"])
def test_convolution3d_matches_jax(mode):
    rng = np.random.default_rng(2)
    img = rng.normal(size=(8, 10, 12)).astype(np.float32)
    k = rng.uniform(size=(3, 5, 3)).astype(np.float32)
    assert _rel(api.convolution3d(img, k, mode, device="cpu"),
                japi.convolution3d(img, k, mode)) <= STEP_TOL


def test_iterate_fft_matches_jax():
    imgs, k1s, k2s, ws = _views(1, (12, 10, 9), 4, False)
    psi0 = np.full(imgs[0].shape, float(np.mean(imgs)), np.float32)
    args = (psi0, imgs[0], k1s[0], k2s[0], ws[0])
    assert _rel(api.iterate_fft_plain(*args, device="cpu"),
                japi.iterate_fft_plain(*args)) <= STEP_TOL
    assert _rel(api.iterate_fft_tikhonov(*args, lambda_=0.006, device="cpu"),
                japi.iterate_fft_tikhonov(*args, lambda_=0.006)) <= STEP_TOL


def test_native_entry_iterate_output_write_only():
    """The bridge's iterate_fft_* start psi from the INPUT buffer; the output
    buffer is write-only (src/multiviewnative.cu:463-465): garbage in it
    must not leak into the result (test_api.py's case)."""
    rng = np.random.default_rng(7)
    view = rng.gamma(2.0, 20.0, (8, 8, 8)).astype(np.float32)
    kernel = gaussian_kernel((3, 3, 3), 1.0)

    def run(fill):
        out = np.full(view.shape, fill, np.float32)
        native_entry.iterate_fft_plain(
            view.ctypes.data, kernel.ctypes.data, out.ctypes.data, view.shape, kernel.shape,
            "cpu",
        )
        return out

    a = run(np.nan)  # uninitialized-style garbage
    np.testing.assert_array_equal(a, run(123.0))
    want = api.iterate_fft_plain(view.copy(), view, kernel, np.flip(kernel).copy(),
                                 np.ones_like(view), device="cpu")
    np.testing.assert_array_equal(a, want)
    jax_out = np.full(view.shape, np.nan, np.float32)
    from libmultiviewnative_tpu import native_entry as jentry

    jentry.iterate_fft_plain(view.ctypes.data, kernel.ctypes.data, jax_out.ctypes.data,
                             view.shape, kernel.shape)
    assert _rel(a, jax_out) <= STEP_TOL

    out_t = np.full(view.shape, np.nan, np.float32)
    native_entry.iterate_fft_tikhonov(
        view.ctypes.data, kernel.ctypes.data, out_t.ctypes.data, view.shape, kernel.shape,
        1e-4, 0.006, "cpu",
    )
    np.testing.assert_array_equal(out_t, api.iterate_fft_tikhonov(
        view, view, kernel, np.flip(kernel).copy(), np.ones_like(view), lambda_=0.006,
        device="cpu"))


def test_native_entry_writes_in_place():
    """compute_quotient and compute_final_values write into the caller's
    memory (the reference's pointer semantics, .h:84-86)."""
    rng = np.random.default_rng(8)
    a = rng.gamma(2.0, 5.0, 64).astype(np.float32)
    b = rng.gamma(2.0, 5.0, 64).astype(np.float32)
    w = np.full(64, 0.5, np.float32)
    out = b.copy()
    native_entry.compute_quotient(a.ctypes.data, out.ctypes.data, out.size, "cpu")
    np.testing.assert_array_equal(out, japi.quotient_flat(a, b))
    psi = a.copy()
    native_entry.compute_final_values(psi.ctypes.data, b.ctypes.data, w.ctypes.data, psi.size,
                                      1e-4, 0.0, "cpu")
    np.testing.assert_array_equal(psi, japi.final_values_flat(a, b, w, lambda_=0.0))


def test_native_entry_refuses_a_missing_card_before_writing():
    """A CUDA device this host does not have raises before any buffer is
    touched; nothing runs on the CPU instead."""
    n = torch.cuda.device_count()
    a = np.ones(16, np.float32)
    out = np.full(16, 7.0, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native_entry.compute_quotient(a.ctypes.data, out.ctypes.data, out.size, f"cuda:{n}")
    np.testing.assert_array_equal(out, np.full(16, 7.0, np.float32))


def test_device_queries():
    n = api.get_num_devices()
    assert n == torch.cuda.device_count()
    if n == 0:
        for query in (api.get_device_name, api.get_device_mem, api.get_device_info,
                      api.get_compute_capability):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                query(0)
        with pytest.raises(RuntimeError):
            api.select_device()
        return
    info = api.get_device_info(0)
    assert info["platform"] == "gpu" and info["kind"] == api.get_device_name(0)
    assert info["memory_bytes"] == api.get_device_mem(0) > 0
    assert 0 <= api.select_device() < n


def test_flat_functions_default_to_the_card():
    """Without ``device`` a flat function runs on the card; where there is
    none it raises, and never computes on the CPU."""
    a = np.ones((4, 4, 4), np.float32)
    if torch.cuda.is_available():
        np.testing.assert_array_equal(api.quotient_flat(a, a), a)
        return
    with pytest.raises((AssertionError, RuntimeError)):
        api.quotient_flat(a, a)
