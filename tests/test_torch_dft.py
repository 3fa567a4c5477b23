"""The port's matmul-DFT engine (core/dft.py, ``algorithm="dft"``) against
the JAX package's on the same numpy inputs, and JAX-prepared spectra carried
across (the dft layouts, and the fused engine's split-x layout).

Tolerance: 1e-5 of max|JAX|.  Both packages run the same float32 products
(the JAX ones at ``precision=HIGHEST``), in another summation order: about
4e-7 of max seen for one transform on the CPU, and 7e-7 after 3 iterations
of 4 views.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.core import dft as jdft
from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_torch.core import dft
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.interop import multiview_data_from_numpy, prepared_from_jax
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
V = 4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair_rel(got, want):
    """A (re, im) pair compared as one array."""
    flat = lambda p: np.concatenate([np.ravel(np.asarray(a)) for a in p])
    return _rel(flat(got), flat(want))


# compact plans; a split long axis (288 = 2·144); a dense prime above 256
@pytest.mark.parametrize("shape", [(8, 12, 16), (16, 24, 32), (8, 16, 288), (4, 6, 257)], ids=str)
def test_transforms_match_jax(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.uniform(size=(3, 5, 3)).astype(np.float32)
    jplan = jdft.make_plan(shape)
    plan = dft.make_plan(shape, device="cpu")
    assert isinstance(plan, dft.FullDFTPlan) == isinstance(jplan, jdft.FullDFTPlan)
    if isinstance(plan, dft.FullDFTPlan):
        assert [a.kind for a in plan.axes] == [a.kind for a in jplan.axes]
    want = jdft.dft3(jnp.asarray(x), jplan)
    got = dft.dft3(torch.from_numpy(x))
    assert _pair_rel([g.numpy() for g in got], want) <= TOL
    assert _rel(dft.idft3(*got, plan).numpy(), jdft.idft3(*want, jplan)) <= TOL
    k_want = jdft.kernel_spectrum_split(jnp.asarray(k), shape)
    k_got = dft.kernel_spectrum_split(torch.from_numpy(k), shape)
    assert _pair_rel([g.numpy() for g in k_got], k_want) <= TOL
    assert _rel(dft.dft_convolve_spectrum(torch.from_numpy(x), *k_got).numpy(),
                jdft.dft_convolve_spectrum(jnp.asarray(x), *k_want)) <= TOL


def test_pick_split_matches_jax():
    for n in (257, 264, 288, 300, 384, 512, 1000, 1021):
        assert dft._pick_split(n) == jdft._pick_split(n)


def _inputs(scalar_weights=False, shape=(12, 10, 9), seed=0):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(V)])
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
     dict(lam=0.0, view_order="simultaneous", adjoint_kernel2=True)],
    ids=["plain", "tikhonov", "simultaneous", "simultaneous-adjoint"],
)
def test_deconvolve_dft_matches_jax(kw):
    psi0, views, k1, k2, w = _inputs(scalar_weights="adjoint_kernel2" in kw)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    want = jrl.deconvolve_jit(jnp.asarray(psi0), jdata, 3, algorithm="dft", **kw)
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    got = rl.deconvolve(torch.from_numpy(psi0), data, 3, algorithm="dft", **kw)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("shape", [(12, 10, 9), (8, 8, 264)], ids=["compact", "full-plan"])
def test_prepared_dft_and_prepared_from_jax(shape):
    """prepare_workspace("dft") and JAX's dft spectra carried across (the
    compact pair, and the FullDFTPlan pair at X = 264 = 2·132) give JAX's
    prepared result; the adjoint materialises the negated imaginary part."""
    psi0, views, k1, k2, w = _inputs(scalar_weights=True, shape=shape)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    jprep = jrl.prepare_workspace(jdata, shape, algorithm="dft", adjoint_kernel2=True)
    want = jrl.deconvolve_prepared(jnp.asarray(psi0), jdata, jprep, 2, lam=0.006)
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    own = rl.prepare_workspace(data, shape, algorithm="dft", adjoint_kernel2=True)
    assert own.algorithm == "dft" and not own.conj_k2
    torch.testing.assert_close(own.k2[1], -own.k1[1], rtol=0, atol=0)
    carried = prepared_from_jax("dft", shape, tuple(map(np.asarray, jprep.k1)),
                                tuple(map(np.asarray, jprep.k2)), device="cpu")
    for prepared in (own, carried):
        got = rl.deconvolve_prepared(torch.from_numpy(psi0), data, prepared, 2, lam=0.006)
        assert _rel(got.numpy(), want) <= TOL


def test_fused_splitx_spectra_from_jax():
    """JAX's fused spectra prepared under ``set_matmul_precision("high")`` at
    a shape where split-x is eligible (X = 256: X >= 256, X/4 % 16 == 0) come
    in the split-x row layout; loaded into the port's standard layout they
    give the port's own fp32 spectra to bf16_3x's error and, through
    deconvolve_prepared, its result within the fused engine's 1e-5."""
    shape, n = (16, 16, 256), 1
    rng = np.random.default_rng(5)
    views = rng.gamma(2.0, 20.0, (n,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(n)])
    w = np.full((n,), 1.0 / n, np.float32)
    psi0 = np.full(shape, views.mean(), np.float32)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k1, w)))
    jdft.set_matmul_precision("high")
    try:
        jprep = jrl.prepare_workspace(jdata, shape, algorithm="fused", adjoint_kernel2=True)
    finally:
        jdft.set_matmul_precision("highest")
    assert jprep.xmode == "splitx"
    carried = prepared_from_jax("fused", shape, tuple(map(np.asarray, jprep.k1)),
                                tuple(map(np.asarray, jprep.k2)), xmode="splitx", device="cpu")
    data = multiview_data_from_numpy(views, k1, k1, w, device="cpu")
    own = rl.prepare_workspace(data, shape, algorithm="fused")
    assert carried.xmode == own.xmode == "standard"
    assert _pair_rel([k.numpy() for k in carried.k1], [k.numpy() for k in own.k1]) <= 1e-4
    got = rl.deconvolve_prepared(torch.from_numpy(psi0), data, carried, 2, lam=0.006)
    want = rl.deconvolve_prepared(torch.from_numpy(psi0), data, own, 2, lam=0.006)
    assert _rel(got.numpy(), want.numpy()) <= TOL


def test_precision_names_and_the_fp32_pin(monkeypatch):
    """"high" is accepted and runs fp32 like "highest" (bitwise); an unknown
    name raises; every product runs at fp32 matmul precision whatever the
    caller set, and the caller's setting is back afterwards."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(8, 12, 16)).astype(np.float32))
    k = dft.kernel_spectrum_split(torch.ones((3, 3, 3)) / 27, (8, 12, 16))
    want = dft.dft_convolve_spectrum(x, *k)
    assert dft._PREC == "highest"
    matmul = torch.backends.cuda.matmul
    before = (matmul.fp32_precision, torch.get_float32_matmul_precision())
    einsum, seen = torch.einsum, []

    def spy(*a):
        seen.append((matmul.fp32_precision, torch.get_float32_matmul_precision()))
        return einsum(*a)

    monkeypatch.setattr(dft, "_EINSUM", spy)
    try:
        dft.set_matmul_precision("high")
        matmul.allow_tf32 = True
        caller = matmul.fp32_precision
        got = dft.dft_convolve_spectrum(x, *k)
        assert matmul.fp32_precision == caller
    finally:
        dft.set_matmul_precision("highest")
        torch.set_float32_matmul_precision(before[1])
        matmul.fp32_precision = before[0]
    assert seen and all(s == ("ieee", "highest") for s in seen)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(KeyError):
        dft.set_matmul_precision("medium")
