"""The port's RL drivers against the JAX package's fft engine
(``deconvolve_jit(..., algorithm="fft")``) on the same numpy inputs, and
against the golden pack.

Tolerance: max|port - jax| <= 1e-4 · max|jax psi|.  The two packages use
different FFT libraries (pocketfft through XLA, and PyTorch's), whose
per-transform differences (~1e-7 relative) compound over the view steps
(4 views × 3 iterations = 12 steps, 4 transforms each).  Measured on the
CPU: at most 8.3e-7 relative (the scalar-weights adjoint case).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_tpu.reference.numpy_ref import np_deconvolve
from libmultiviewnative_torch.core.dft import make_plan
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.deconv.workspace import (
    MultiViewData,
    View,
    WeightNormalizationWarning,
    Workspace,
    initial_psi,
)
from libmultiviewnative_torch.interop import multiview_data_from_numpy, prepared_from_jax
from libmultiviewnative_torch.ops import elementwise as ew
from libmultiviewnative_torch.reference.oracle import (
    l2norm,
    l2norm_within_limits,
    rms_within_limits,
)
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-4
SHAPE = (12, 10, 9)  # odd X: the inverse FFT needs its s=
V = 4


def _inputs(scalar_weights=False, seed=0):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (V,) + SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(V)])
    k2 = np.stack([np.flip(k).copy() for k in k1])
    if scalar_weights:
        w = np.full((V,), 1.0 / V, np.float32)
    else:
        w = rng.uniform(0.5, 1.5, (V,) + SHAPE).astype(np.float32)
        w /= w.sum(axis=0, keepdims=True)
    psi0 = np.full(SHAPE, views.mean(), np.float32)
    return psi0, views, k1, k2, w


def _jax(psi0, views, k1, k2, w, **kw):
    data = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    return np.asarray(jrl.deconvolve_jit(jnp.asarray(psi0), data, algorithm="fft", **kw))


def _port(psi0, views, k1, k2, w, **kw):
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    return rl.deconvolve(torch.from_numpy(psi0), data, **kw).numpy()


def _close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


@pytest.mark.parametrize(
    "case, kw",
    [
        ("sequential-tikhonov", dict(lam=0.006)),
        ("sequential-plain", dict(lam=0.0)),
        ("scalar-weights-adjoint", dict(lam=0.006, adjoint_kernel2=True)),
        ("simultaneous", dict(lam=0.006, view_order="simultaneous")),
        ("simultaneous-adjoint", dict(lam=0.0, view_order="simultaneous", adjoint_kernel2=True)),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_deconvolve_matches_jax_fft_engine(case, kw):
    args = _inputs(scalar_weights="scalar" in case or "adjoint" in case)
    common = dict(num_iterations=3, min_value=1e-4, **kw)
    psi0 = args[0].copy()
    got = _port(*args, **common)
    np.testing.assert_array_equal(args[0], psi0)  # the caller's psi is not written
    _close(got, _jax(*args, **common))


def test_auto_resolves_to_fft_and_counts_no_cpu_launches():
    """On the CPU ``"auto"`` is the JAX package's rule there: at this shape
    (every axis at most 256) the dft engine, bit for bit; above 256 fft.
    The CPU path counts no kernel launches."""
    args = _inputs()
    ew.reset_launches()
    got = _port(*args, num_iterations=2, lam=0.006, algorithm="auto")
    want = _port(*args, num_iterations=2, lam=0.006, algorithm="dft")
    np.testing.assert_array_equal(got, want)
    assert rl.resolve_algorithm("auto", SHAPE, "cpu") == "dft"
    assert rl.resolve_algorithm("auto", (257, 8, 8), "cpu") == "fft"
    assert set(ew.launches.values()) == {0}  # the CPU path runs the plain versions


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
def test_driver_under_the_cuda_fft_layout(monkeypatch, view_order):
    """On CUDA a 3D rfftn returns an (X//2+1, Z, Y) memory order (batched
    ones are contiguous).  The same layout on the CPU gives bitwise the same
    result: the kernel spectra are stacked in it and K3 meets x̂ in it."""
    from libmultiviewnative_torch.core import convolve, fft

    args = _inputs()
    kw = dict(num_iterations=2, lam=0.006, min_value=1e-4, view_order=view_order)
    want = _port(*args, **kw)

    def cuda_like_rfft3(x):
        out = torch.fft.rfftn(x, dim=(-3, -2, -1))
        return out.permute(2, 0, 1).contiguous().permute(1, 2, 0) if out.ndim == 3 else out

    monkeypatch.setattr(convolve, "rfft3", cuda_like_rfft3)
    monkeypatch.setattr(rl, "rfft3", cuda_like_rfft3)
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    assert not rl.prepare_spectra(data.kernel1, SHAPE)[0].is_contiguous()
    np.testing.assert_array_equal(_port(*args, **kw), want)
    assert fft.rfft3 is not cuda_like_rfft3


@pytest.mark.parametrize("algorithm", ["dft", "fused", "direct"])
def test_unported_engines_raise(algorithm):
    """Every engine is ported now, and none raises.  dft and direct agree
    with the fft engine (and tests/test_torch_dft.py and test_torch_direct.py
    hold them against JAX's).  The fused engine runs the dense spectrum
    forwarding (pass BF, K5): a kernel z-extent of 9 at Z = 16.  Its split-x
    spectrum layout loads from the JAX package (tests/test_torch_dispatch.py
    holds the values); an unknown layout is refused."""
    args = _inputs()
    if algorithm == "fused":
        rng = np.random.default_rng(4)
        views = rng.gamma(2.0, 20.0, (V, 16, 16, 16)).astype(np.float32)
        k = np.stack([gaussian_kernel((9, 9, 9), 1.5)] * V)
        args = (np.full((16, 16, 16), views.mean(), np.float32), views, k, k,
                np.full((V,), 1.0 / V, np.float32))
        fused = _port(*args, num_iterations=1, algorithm="fused")
        _close(fused, _port(*args, num_iterations=1, algorithm="fft"))
        with pytest.raises(ValueError, match="x-row layout"):
            prepared_from_jax("fused", (16, 16, 16), (k, k), (k, k), xmode="fold", device="cpu")
        return
    _close(_port(*args, num_iterations=1, algorithm=algorithm),
           _port(*args, num_iterations=1, algorithm="fft"))


def test_adjoint_requires_odd_kernel_dims():
    psi0, views, k1, k2, w = _inputs(scalar_weights=True)
    k_even = np.zeros((V, 4, 5, 5), np.float32)
    data = multiview_data_from_numpy(views, k_even, k_even, w, device="cpu")
    with pytest.raises(ValueError, match="odd kernel1 dims"):
        rl.deconvolve(torch.from_numpy(psi0), data, 1, adjoint_kernel2=True)
    with pytest.raises(ValueError, match="odd kernel1 dims"):
        rl.prepare_workspace(data, SHAPE, adjoint_kernel2=True)


def test_history_deltas_match_jax():
    args = _inputs()
    kw = dict(num_iterations=3, lam=0.006, min_value=1e-4)
    data = JaxData(*(jnp.asarray(a) for a in args[1:]))
    jpsi, jdeltas = jrl.deconvolve_with_history(jnp.asarray(args[0]), data, algorithm="fft", **kw)
    psi, deltas = rl.deconvolve_with_history(
        torch.from_numpy(args[0]), multiview_data_from_numpy(*args[1:], device="cpu"), **kw
    )
    assert deltas.shape == (3,)
    _close(psi.numpy(), np.asarray(jpsi))
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas), rtol=1e-3)
    assert deltas[-1] < deltas[0]


@pytest.mark.parametrize("adjoint", [False, True], ids=["kernel2", "adjoint"])
def test_prepared_spectra_from_jax(adjoint):
    """JAX's prepared spectra, carried across as numpy, drive the port's
    prepared path to JAX's own prepared result."""
    psi0, views, k1, k2, w = _inputs(scalar_weights=adjoint)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    jprep = jrl.prepare_workspace(jdata, SHAPE, algorithm="fft", adjoint_kernel2=adjoint)
    kw = dict(num_iterations=3, lam=0.006, min_value=1e-4)
    want = np.asarray(jrl.deconvolve_prepared(jnp.asarray(psi0), jdata, jprep, **kw))
    prepared = prepared_from_jax(
        "fft", SHAPE, np.asarray(jprep.k1), np.asarray(jprep.k2), device="cpu"
    )
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    got = rl.deconvolve_prepared(torch.from_numpy(psi0), data, prepared, **kw).numpy()
    _close(got, want)
    own = rl.prepare_workspace(data, SHAPE, algorithm="fft", adjoint_kernel2=adjoint)
    assert own.algorithm == "fft" and own.conj_k2 == adjoint
    _close(rl.deconvolve_prepared(torch.from_numpy(psi0), data, own, **kw).numpy(), want)


def test_prepared_shape_guard_and_interop_engine_guard():
    psi0, views, k1, k2, w = _inputs()
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    prepared = rl.prepare_workspace(data, (12, 10, 8))
    with pytest.raises(ValueError, match="prepared spectra are for"):
        rl.deconvolve_prepared(torch.from_numpy(psi0), data, prepared, 1)
    with pytest.raises(ValueError, match="direct"):
        prepared_from_jax("direct", SHAPE, None, None, device="cpu")


def test_workspace_wrapper_and_float64_reference():
    """deconvolve_workspace on views built through the containers, against
    the JAX package's float64 numpy mirror of the reference algorithm."""
    psi0, views, k1, k2, w = _inputs()
    ws = Workspace.from_views(
        [View(views[v], k1[v], k2[v], w[v]) for v in range(V)],
        lambda_=0.006, min_value=1e-4, num_iterations=2,
        device="cpu",
    )
    psi = initial_psi(ws.data)
    torch.testing.assert_close(psi, torch.from_numpy(psi0), rtol=1e-6, atol=0)
    got = rl.deconvolve_workspace(psi, ws).numpy()
    want = np_deconvolve(psi0, views, k1, k2, w, 2, 0.006, 1e-4)
    _close(got, want)


def test_from_views_pads_kernels_and_checks_weights():
    psi0, views, k1, k2, w = _inputs()
    small = gaussian_kernel((3, 3, 3), 1.0)
    data = MultiViewData.from_views(
        [View(views[0], k1[0], k2[0], w[0]), View(views[1], small, small, w[1])],
        device="cpu",
    )
    assert data.kernel1.shape == (2, 5, 5, 5) and data.num_views == 2
    assert float(data.kernel1[1, 2, 2, 2]) == pytest.approx(float(small[1, 1, 1]))
    assert data.to("cpu").spatial_shape == SHAPE
    with pytest.raises(ValueError, match="share the image shape"):
        MultiViewData.from_views(
            [View(views[0], k1[0], k2[0], w[0]), View(views[1][:4], k1[1], k2[1], w[1][:4])],
            device="cpu",
        )
    bad = multiview_data_from_numpy(views, k1, k2, np.ones((V,), np.float32), device="cpu")
    with pytest.warns(WeightNormalizationWarning):
        rl.deconvolve(torch.from_numpy(psi0), bad, 1, view_order="simultaneous")


@pytest.mark.parametrize(
    "entry",
    ["MultiViewData.from_views", "Workspace.from_views", "multiview_data_from_numpy",
     "prepared_from_jax", "make_plan"],
)
def test_entry_points_default_to_the_card(entry):
    """Without a ``device`` argument the entry points put their tensors on
    the card; where there is none they raise, and never hand back CPU
    tensors."""
    psi0, views, k1, k2, w = _inputs()
    spectra = np.zeros((V, *SHAPE[:2], SHAPE[2] // 2 + 1), np.complex64)
    call = {
        "MultiViewData.from_views": lambda: MultiViewData.from_views(
            [View(views[v], k1[v], k2[v], w[v]) for v in range(V)]
        ).views,
        "Workspace.from_views": lambda: Workspace.from_views(
            [View(views[v], k1[v], k2[v], w[v]) for v in range(V)]
        ).data.views,
        "multiview_data_from_numpy": lambda: multiview_data_from_numpy(views, k1, k2, w).views,
        "prepared_from_jax": lambda: prepared_from_jax("fft", SHAPE, spectra, spectra).k1,
        "make_plan": lambda: make_plan(SHAPE).fcx,
    }[entry]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        call()


PACK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden_mv6.npz")


@pytest.mark.parametrize(
    "iters, golden, gate", [(2, "psi_1", 1e-3), (5, "psi_4", 2e-3)], ids=["2it", "5it"]
)
def test_golden_pack(iters, golden, gate):
    """The gates of tests/test_golden_regression.py:83-96."""
    with np.load(PACK) as z:
        pack = {k: z[k] for k in z.files}
    data = MultiViewData.from_views(
        [
            View(pack[f"view_{v}"], pack[f"kernel1_{v}"], pack[f"kernel2_{v}"], pack[f"weights_{v}"])
            for v in range(6)
        ],
        device="cpu",
    )
    out = rl.deconvolve(
        torch.from_numpy(pack["psi_0_start"]), data, iters,
        lam=float(pack["lambda"]), min_value=float(pack["min_value"]),
    ).numpy()
    assert l2norm(out, pack[golden]) < gate
    assert l2norm_within_limits(out, pack[golden], 0.3, 0.7) < gate
    assert rms_within_limits(out, pack[golden], 0.3, 0.7) < 5e-3
