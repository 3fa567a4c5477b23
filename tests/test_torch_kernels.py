"""The port's elementwise kernels (K1-K3) against the JAX package's Pallas
kernels, run in interpret mode as tests/test_pallas_ops.py runs them.

On the CPU every wrapper of libmultiviewnative_torch.ops.elementwise runs its
plain PyTorch version; these tests hold those against the Pallas kernels.
The CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.core.kernels import rl_update as jax_rl_update
from libmultiviewnative_tpu.ops.pallas.elementwise import (
    quotient_pallas,
    rl_update_pallas,
    spectral_multiply_pallas,
)
from libmultiviewnative_torch.ops import _build
from libmultiviewnative_torch.ops import elementwise as ew

torch.set_num_threads(1)


@pytest.fixture(params=[(8, 16, 16), (7, 9, 13), (3, 256, 130)], ids=str)
def vol(request):
    rng = np.random.default_rng(1308)
    shape = request.param
    return (
        rng.gamma(2.0, 5.0, shape).astype(np.float32),
        rng.gamma(2.0, 0.5, shape).astype(np.float32),
        rng.uniform(0.0, 1.0, shape).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "lam, rtol, atol",
    [
        (0.0, 1e-6, 1e-6),
        # sqrt lowers differently in the Pallas interpreter: single-ulp
        # disagreements on isolated elements (tests/test_pallas_ops.py:45-47)
        (0.006, 2e-4, 5e-5),
    ],
)
def test_rl_update_matches_pallas(vol, lam, rtol, atol):
    psi, integral, w = vol
    want = np.asarray(rl_update_pallas(psi, integral, w, lam, 1e-4, interpret=True))
    got = ew.rl_update(_t(psi), _t(integral), _t(w), lam, 1e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_rl_update_in_place_and_scalar_weight(vol):
    psi, integral, _ = vol
    want = np.asarray(
        rl_update_pallas(psi, integral, np.full_like(psi, 0.25), 0.0, 1e-4, interpret=True)
    )
    p = _t(psi.copy())
    got = ew.rl_update(p, _t(integral), 0.25, 0.0, 1e-4, out=p)
    assert got.data_ptr() == p.data_ptr()
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_rl_update_edge_values(lam):
    psi = np.array([[1.0, 1.0, 1.0, 0.0]], np.float32)
    integral = np.array([[np.nan, np.inf, -2.0, 3.0]], np.float32)
    w = np.ones((1, 4), np.float32)
    want = np.asarray(rl_update_pallas(psi, integral, w, lam, 1e-4, interpret=True))
    got = ew.rl_update(_t(psi), _t(integral), _t(w), lam, 1e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_rl_update_tensor_lambda_matches_jax(vol, lam):
    """A tensor λ selects between both branches (safe λ=1 in the unselected
    one) and gives the values of the Python-λ program.  XLA's and PyTorch's
    CPU sqrt differ by an ulp on some elements, which the cancellation in
    sqrt(1 + 2λv) - 1 amplifies: the tolerance of test_pallas_ops.py:47."""
    psi, integral, w = vol
    want = np.asarray(jax_rl_update(psi, integral, w, jnp.float32(lam), 1e-4))
    got = ew.rl_update_plain(_t(psi), _t(integral), _t(w), torch.tensor(lam), 1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=5e-5)
    static = ew.rl_update_plain(_t(psi), _t(integral), _t(w), lam, 1e-4)
    np.testing.assert_array_equal(got.numpy(), static.numpy())


def test_quotient_matches_pallas(vol):
    view, integral, _ = vol
    want = np.asarray(quotient_pallas(view, integral, interpret=True))
    got = ew.quotient(_t(view), _t(integral)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_quotient_is_reciprocal_then_multiply():
    """K2's order, which K8's x stage shares: view · (1/integral), rounded
    twice, not view / integral, rounded once.  The inputs are drawn until
    the two orders differ on many elements; the plain version (and the
    wrapper on the CPU) must equal the first bitwise."""
    rng = np.random.default_rng(2)
    view = rng.uniform(0.0, 200.0, 4096).astype(np.float32)
    integral = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    want = view * (np.float32(1.0) / integral)
    assert (want != view / integral).sum() > 100
    for got in (ew.quotient_plain(_t(view), _t(integral)), ew.quotient(_t(view), _t(integral))):
        np.testing.assert_array_equal(got.numpy(), want)


def test_k2_and_k8_share_one_quotient():
    """One device function computes the quotient for K2 (elementwise.cu)
    and for K8's x stage (fft_stage.cuh, its QuotientOp): lmvn::quotient_one,
    reciprocal then multiply; neither source spells out a quotient of its
    own."""
    csrc = _build._CSRC
    header = (csrc / "rl_update.cuh").read_text()
    body = header.split("float quotient_one(float view, float integral) {")[1].split("}")[0]
    assert body.strip() == "return view * (1.f / integral);"
    for name, kernel in (("elementwise.cu", "lmvn_quotient"), ("fft_stage.cuh", "QuotientOp")):
        source = (csrc / name).read_text()
        assert "lmvn::quotient_one" in source and kernel in source, name
        assert "(1.f /" not in source, name


def test_k1_k9_and_k10_share_one_update():
    """One device function computes the RL update for K1 (elementwise.cu)
    and for the x stage of K9 and K10 (fft_stage.cuh, its RlUpdateOp):
    lmvn::rl_one.  So K9 of a spectrum is K1 of K7's output bit for bit (the
    x stage hands rl_one the value K7 stores), which chip_smoke.py checks on
    the card; neither source spells out an update of its own."""
    csrc = _build._CSRC
    assert "float rl_one(float psi, float integral, float w," in (csrc / "rl_update.cuh").read_text()
    for name, kernel in (("elementwise.cu", "lmvn_rl_update"), ("fft_stage.cuh", "RlUpdateOp")):
        source = (csrc / name).read_text()
        assert "rl_one(" in source and kernel in source, name
        assert "sqrtf(" not in source, name


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


@pytest.mark.parametrize(
    "xshape, kshape",
    [((4, 8, 5), (4, 8, 5)), ((3, 4, 8, 5), (4, 8, 5))],
    ids=["same", "batch-broadcast"],
)
def test_spectral_multiply_matches_pallas(xshape, kshape):
    rng = np.random.default_rng(7)
    a, b = _cplx(rng, xshape), _cplx(rng, kshape)
    want = np.asarray(spectral_multiply_pallas(a, b, interpret=True))
    got = ew.spectral_multiply(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spectral_multiply_conj_matches_pallas():
    rng = np.random.default_rng(8)
    a, b = _cplx(rng, (2, 4, 8, 5)), _cplx(rng, (4, 8, 5))
    want = np.asarray(spectral_multiply_pallas(a, np.conj(b), interpret=True))
    x = _t(a)
    got = ew.spectral_multiply(x, _t(b), conj_k=True, out=x)
    assert got.data_ptr() == x.data_ptr()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_spectral_multiply_takes_a_shared_permuted_layout():
    """cuFFT's 3D rfftn returns an (X//2+1, Z, Y) memory order: K3 takes any
    dense layout x̂ and k̂ share, and layout_like makes one that differs."""
    rng = np.random.default_rng(9)
    a, b = _cplx(rng, (2, 6, 4, 5)), _cplx(rng, (6, 4, 5))
    want = np.asarray(spectral_multiply_pallas(a, b, interpret=True))
    k = _t(b).permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert not k.is_contiguous()
    with pytest.raises(ValueError, match="memory order"):
        ew.spectral_multiply(_t(a), k)
    x = ew.layout_like(_t(a), k)
    assert x.stride()[1:] == k.stride() and ew.layout_like(x, k) is x
    got = ew.spectral_multiply(x, k, out=x)
    assert got.stride() == x.stride()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_operands():
    x = torch.zeros((2, 3, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="resolve_conj"):
        ew.spectral_multiply(x, x.conj())
    with pytest.raises(ValueError, match="trailing axes"):
        ew.spectral_multiply(x[0], x)
    with pytest.raises(ValueError, match="dense"):
        ew.spectral_multiply(x, torch.zeros((3, 8), dtype=torch.complex64)[:, ::2])
    f = torch.zeros((4, 4, 4))
    with pytest.raises(TypeError, match="float32"):
        ew.quotient(f.double(), f)
    with pytest.raises(ValueError, match="contiguous"):
        ew.quotient(f.transpose(0, 2), f)
    with pytest.raises(ValueError, match="shape"):
        ew.rl_update(f, f[:2], 1.0, 0.0, 1e-4)


def test_non_cpu_request_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor reaches a plain version: another device raises, and
    a CUDA request on a host without CUDA raises instead of falling back."""

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("rl_update_plain", "quotient_plain", "spectral_multiply_plain"):
        monkeypatch.setattr(ew, name, boom)
    ew.reset_launches()
    m = torch.empty((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ew.quotient(m, m)
    with pytest.raises(ValueError, match="unsupported device"):
        ew.rl_update(m, m, m, 0.0, 1e-4)
    mc = torch.empty((4, 4, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ew.spectral_multiply(mc, mc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _build.library()
    assert ew.launches == {"rl_update": 0, "quotient": 0, "spectral_multiply": 0}


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
