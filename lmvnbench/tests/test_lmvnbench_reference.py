"""The plain reference against a float64 NumPy RL written out here, at 16³
to 32³, for both configurations' options: per-voxel and scalar weights,
the full and the adjoint kernel2, and a batch."""

import numpy as np
import pytest
import torch

from lmvnbench import inputs, reference


def np_wrap(k, shape):
    buf = np.zeros(shape)
    buf[tuple(slice(0, s) for s in k.shape)] = k
    return np.roll(buf, [-(s // 2) for s in k.shape], axis=(0, 1, 2))


def np_rl(psi, views, k1, k2, weights, iterations, lam, min_value):
    """Sequential multi-view RL in float64 NumPy, one volume."""
    shape = psi.shape
    k1_hat = [np.fft.rfftn(np_wrap(k, shape)) for k in k1]
    k2_hat = [np.fft.rfftn(np_wrap(k, shape)) for k in k2]
    conv = lambda x, kh: np.fft.irfftn(np.fft.rfftn(x) * kh, s=shape, axes=(0, 1, 2))
    for _ in range(iterations):
        for v in range(len(views)):
            integral = conv(psi, k1_hat[v])
            integral = views[v] * (1.0 / integral)
            integral = conv(integral, k2_hat[v])
            value = psi * integral
            with np.errstate(invalid="ignore"):
                tik = (np.sqrt(1.0 + 2.0 * lam * value) - 1.0) / lam if lam > 0 else value
            value = np.where(value > 0.0, tik, min_value)
            nxt = np.where(np.isfinite(value), np.maximum(value, min_value), min_value)
            psi = weights[v] * (nxt - psi) + psi
    return psi


def case(shape, k1_shape, k2_shape, adjoint, per_voxel, seed, views=3):
    cfg = {"shape": list(shape), "views": views,
           "kernel1": {"shape": list(k1_shape), "sigma0": 1.0, "sigma_step": 0.4},
           "kernel2_shape": list(k2_shape), "adjoint_kernel2": adjoint,
           "weights": "per_voxel" if per_voxel else "per_view",
           "view_gamma": {"shape": 2, "scale": 20.0}}
    k1, k2 = inputs.kernels(cfg, "cpu")
    w = inputs.weights(cfg, "cpu")
    v = inputs.stack_views(cfg, seed, 0, "cpu")
    return cfg, k1, k2, w, v


@pytest.mark.parametrize("shape,k1s,k2s,adjoint,per_voxel", [
    ((16, 16, 16), (5, 5, 5), (7, 7, 7), False, True),
    ((16, 24, 16), (5, 3, 7), (5, 3, 7), True, False),
    ((32, 32, 32), (21, 21, 21), (25, 25, 25), False, True),
    ((32, 32, 32), (21, 21, 21), (21, 21, 21), True, False),
])
def test_reference_matches_numpy(shape, k1s, k2s, adjoint, per_voxel):
    cfg, k1, k2, w, views = case(shape, k1s, k2s, adjoint, per_voxel, seed=11)
    psi0 = torch.full(shape, float(views.mean()))
    got = reference.deconvolve(psi0, views, k1, k2, w, 3, 0.006, 1e-4, adjoint)
    np_k2 = [np.flip(k.numpy().astype(np.float64)) for k in k1] if adjoint else [
        k.numpy().astype(np.float64) for k in k2]
    np_w = [x.numpy().astype(np.float64) for x in w]
    want = np_rl(psi0.numpy().astype(np.float64), [x.numpy().astype(np.float64) for x in views],
                 [k.numpy().astype(np.float64) for k in k1], np_k2, np_w, 3, 0.006, 1e-4)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_adjoint_equals_flipped_kernel2():
    """Under the adjoint the reference's kernel2 is kernel1 flipped: the
    same result as passing the flipped kernel1 as kernel2."""
    cfg, k1, _, w, views = case((16, 16, 16), (5, 7, 3), (5, 7, 3), True, True, seed=3)
    psi0 = torch.full((16, 16, 16), float(views.mean()))
    flipped = torch.stack([torch.flip(k, (0, 1, 2)) for k in k1])
    a = reference.deconvolve(psi0, views, k1, k1, w, 2, 0.006, 1e-4, adjoint_kernel2=True)
    b = reference.deconvolve(psi0, views, k1, flipped, w, 2, 0.006, 1e-4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_batch_entries_equal_single_calls():
    """A batch (B, Z, Y, X) with views (V, B, Z, Y, X) and shared weights:
    each entry as its own call, and as the NumPy RL."""
    cfg, k1, k2, w, v0 = case((16, 16, 16), (5, 5, 5), (7, 7, 7), False, True, seed=5)
    v1 = inputs.stack_views(cfg, 5, 1, "cpu")
    views = torch.stack([v0, v1], dim=1)
    psi0 = torch.stack([torch.full((16, 16, 16), float(v.mean())) for v in (v0, v1)])
    got = reference.deconvolve(psi0, views, k1, k2, w, 2, 0.006, 1e-4)
    for b, v in enumerate((v0, v1)):
        one = reference.deconvolve(psi0[b], v, k1, k2, w, 2, 0.006, 1e-4)
        torch.testing.assert_close(got[b], one, rtol=1e-13, atol=1e-13)
        want = np_rl(psi0[b].numpy().astype(np.float64), [x.numpy().astype(np.float64) for x in v],
                     [k.numpy().astype(np.float64) for k in k1],
                     [k.numpy().astype(np.float64) for k in k2],
                     [x.numpy().astype(np.float64) for x in w], 2, 0.006, 1e-4)
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_storage_rounding_departs():
    """A run with its stored values rounded to bfloat16 departs from float64
    by far more than float32 does: the control is a step below."""
    cfg, k1, k2, w, views = case((16, 16, 16), (5, 5, 5), (7, 7, 7), False, True, seed=9)
    psi0 = torch.full((16, 16, 16), float(views.mean()))
    exact = reference.deconvolve(psi0, views, k1, k2, w, 3, 0.006, 1e-4)
    f32 = reference.deconvolve(psi0, views, k1, k2, w, 3, 0.006, 1e-4, dtype=torch.float32)
    bf16 = reference.deconvolve(psi0, views, k1, k2, w, 3, 0.006, 1e-4, dtype=torch.float32,
                                storage=torch.bfloat16)
    err = lambda x: float((x.double() - exact).abs().max() / exact.abs().max())
    assert err(f32) < 1e-5
    assert err(bf16) > 100 * err(f32)
