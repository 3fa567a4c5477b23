"""The port's streamed out-of-core rung (deconv/streamed.py) against the JAX
package's on tests/test_streamed.py's problem: 2 views at (16, 12, 12), 5³
kernels, z-chunks of 8 with full halos.

On the CPU (``device="cpu"``) nothing is copied and the kernels' plain
versions run; chip_smoke.py phase 23 runs the rung on the card, with the
pinned staging slots and the side stream.

Tolerances: against JAX's rung, 1e-5 of max|psi| (both transform each
extended chunk at the same extent: about 8e-7 seen); against the port's
in-core ``deconvolve``, the rung's contract in tests/test_streamed.py
(rtol 1e-4, atol 1e-4: the chunks' transforms run at another extent).
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.deconv import streamed as jstreamed
from libmultiviewnative_torch.deconv import rl, streamed
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (16, 12, 12)
V = 2


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    views = [rng.gamma(2.0, 20.0, SHAPE).astype(np.float32) for _ in range(V)]
    k1 = [gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)]
    ws = [np.full(SHAPE, 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full(SHAPE, float(np.mean(views)), np.float32)
    return psi0, views, k1, ws


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
def test_streamed_matches_jax_and_incore(problem, algorithm):
    """kernel2 the flipped kernel1, as ``adjoint_kernel2`` hands it to the
    rung; the caller's psi is not written."""
    psi0, views, k1, ws = problem
    k2 = [np.flip(k).copy() for k in k1]
    before = psi0.copy()
    got = streamed.deconvolve_streamed(psi0, views, k1, k2, ws, 2, lam=0.006, chunk_z=8,
                                       algorithm=algorithm, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(psi0, before)
    want = jstreamed.deconvolve_streamed(psi0, views, k1, k2, ws, 2, lam=0.006, chunk_z=8,
                                         algorithm=algorithm)
    assert _rel(got.numpy(), want) <= TOL
    data = multiview_data_from_numpy(np.stack(views), np.stack(k1), np.stack(k2), np.stack(ws),
                                     device="cpu")
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, lam=0.006, algorithm=algorithm)
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)


def test_streamed_auto_scalar_weights_and_tensors(problem):
    """Scalar weights match constant stacks; CPU tensors are taken as input;
    ``"auto"`` resolves per extended chunk (dft on the CPU at these
    extents); a chunk that does not divide Z leaves a short last chunk."""
    psi0, views, k1, _ = problem
    k2 = [np.flip(k).copy() for k in k1]
    stacks = [np.full(SHAPE, 0.5, np.float32)] * V
    a = streamed.deconvolve_streamed(psi0, views, k1, k2, [0.5] * V, 2, chunk_z=5,
                                     algorithm="auto", device="cpu")
    b = streamed.deconvolve_streamed(torch.from_numpy(psi0), [torch.from_numpy(v) for v in views],
                                     k1, k2, stacks, 2, chunk_z=5, algorithm="dft", device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    want = jstreamed.deconvolve_streamed(psi0, views, k1, k2, stacks, 2, chunk_z=5,
                                         algorithm="auto")
    assert _rel(a.numpy(), want) <= TOL


def test_pick_chunk_z_matches_jax():
    """tests/test_streamed.py's cases, the bench kernels' halos at 512³ and a
    Z with no 5-smooth chunk (both warn and fall back alike)."""
    for Z, pairs in ((512, [(10, 10), (12, 12)]), (512, [(12, 12)]), (96, [(2, 2)]),
                     (40, []), (300, [(10, 10), (3, 4)])):
        got = streamed.pick_chunk_z(Z, pairs)
        assert got == jstreamed.pick_chunk_z(Z, pairs)
        for lo, hi in pairs:
            assert streamed._smooth(got + lo + hi)
    with pytest.warns(RuntimeWarning, match="no FFT-friendly chunk"):
        got = streamed.pick_chunk_z(512, [(120, 121)])
    with pytest.warns(RuntimeWarning, match="no FFT-friendly chunk"):
        assert got == jstreamed.pick_chunk_z(512, [(120, 121)])


def test_extended_chunk_wraps_at_the_ends():
    vol = torch.arange(6.0).reshape(6, 1, 1)
    assert streamed._gather_extended(vol, 0, 2, 2, 3).flatten().tolist() == [4, 5, 0, 1, 2, 3, 4]
    assert streamed._gather_extended(vol, 4, 6, 1, 9).flatten().tolist() == [3, 4, 5] + [0, 1, 2, 3,
                                                                                    4, 5, 0, 1, 2]


def test_streamed_refuses(problem):
    psi0, views, k1, ws = problem
    with pytest.raises(ValueError, match="fft/dft/direct"):
        streamed.deconvolve_streamed(psi0, views, k1, k1, ws, 1, chunk_z=8, algorithm="fused",
                                     device="cpu")
    with pytest.raises(ValueError, match="one entry per view"):
        streamed.deconvolve_streamed(psi0, views, k1[:1], k1, ws, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            streamed.deconvolve_streamed(psi0, views, k1, k1, ws, 1, device="cuda")
