"""The port's interleaved out-of-core rung (deconv/interleaved.py) against the
JAX package's, on tests/test_interleaved.py's problem: 3 views at
(24, 16, 16), 5³ kernels, per-voxel weights, z-chunks of 7 (the last one
shorter).

On the CPU (``device="cpu"``) nothing streams and the kernels' plain
versions run; chip_smoke.py phase 18 runs the rung on the card, with the
pinned copies and the side stream.

Tolerances:
* against JAX's rung: 1e-4 of max|psi|, as the port's slices are held
  against the JAX drivers (tests/test_torch_rl.py, tests/test_torch_fused.py);
* against the port's in-core ``deconvolve`` on the same engine: the rung's
  own contract, rtol 2e-5 and atol 2e-4 (tests/test_interleaved.py:53).
  The chunked quotient and update compute the same values as the in-core
  driver's, so on the CPU the two are in fact bitwise equal.
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.deconv.interleaved import (
    deconvolve_interleaved as jax_deconvolve_interleaved,
)
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.deconv.interleaved import chunk_bounds, deconvolve_interleaved
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-4
ITERS = 2


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    V, shape = 3, (24, 16, 16)
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    k1 = [gaussian_kernel((5, 5, 5), 1.0 + 0.2 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    ws = [rng.uniform(0.2, 0.5, shape).astype(np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean(views)), np.float32)
    return psi0, views, k1, k2, ws


def _rel(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _incore(psi0, views, k1, k2, ws, lam, engine):
    shape = psi0.shape
    data = multiview_data_from_numpy(
        np.stack(views), np.stack(k1), np.stack(k2),
        np.stack([np.broadcast_to(np.asarray(w, np.float32), shape) for w in ws]),
        device="cpu",
    )
    return rl.deconvolve(torch.from_numpy(psi0), data, ITERS, lam=lam, algorithm=engine).numpy()


@pytest.mark.parametrize("engine", ["fft", "fused", "dft"])
@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_interleaved_matches_jax_and_incore(problem, engine, lam):
    psi0, views, k1, k2, ws = problem
    got = deconvolve_interleaved(psi0, views, k1, k2, ws, ITERS, lam=lam, chunk_z=7,
                                 algorithm=engine, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    want = jax_deconvolve_interleaved(psi0, views, k1, k2, ws, ITERS, lam=lam, chunk_z=7,
                                      algorithm=engine)
    assert _rel(got, np.asarray(want)) <= RTOL
    np.testing.assert_allclose(got, _incore(psi0, views, k1, k2, ws, lam, engine),
                               rtol=2e-5, atol=2e-4)


def test_interleaved_scalar_weights(problem):
    """Scalar weights stream nothing and take one whole-volume update; they
    match JAX's rung and the per-voxel path with constant stacks.  CPU
    tensors are taken as inputs too."""
    psi0, views, k1, k2, _ = problem
    scalars = [1.0 / 3.0] * 3
    stacks = [torch.full(psi0.shape, 1.0 / 3.0)] * 3
    a = deconvolve_interleaved(psi0, views, k1, k2, scalars, ITERS, chunk_z=7, algorithm="fft",
                               device="cpu")
    b = deconvolve_interleaved(torch.from_numpy(psi0), [torch.from_numpy(v) for v in views],
                               k1, k2, stacks, ITERS, chunk_z=7, algorithm="fft", device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-6)
    want = jax_deconvolve_interleaved(psi0, views, k1, k2, scalars, ITERS, chunk_z=7,
                                      algorithm="fft")
    assert _rel(a, np.asarray(want)) <= RTOL
    auto = deconvolve_interleaved(psi0, views, k1, k2, scalars, ITERS, chunk_z=7, device="cpu")
    dft = deconvolve_interleaved(psi0, views, k1, k2, scalars, ITERS, chunk_z=7, algorithm="dft",
                                 device="cpu")
    np.testing.assert_array_equal(auto, dft)  # "auto" runs the dft engine at 24x16x16 on the CPU


def test_chunk_bounds_cover_z():
    assert chunk_bounds(24, 7) == [(0, 7), (7, 14), (14, 21), (21, 24)]
    assert chunk_bounds(512, 64)[-1] == (448, 512)


def test_interleaved_refuses_engines_and_devices(problem):
    psi0, views, k1, k2, ws = problem
    with pytest.raises(ValueError, match="interleaved rung supports"):
        deconvolve_interleaved(psi0, views, k1, k2, ws, 1, algorithm="direct", device="cpu")
    with pytest.raises(ValueError, match="interleaved rung supports"):
        deconvolve_interleaved(psi0, views, k1, k2, ws, 1, algorithm="dtf", device="cpu")
    with pytest.raises(ValueError, match="one entry per view"):
        deconvolve_interleaved(psi0, views, k1[:2], k2, ws, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            deconvolve_interleaved(psi0, views, k1, k2, ws, 1, device="cuda")
