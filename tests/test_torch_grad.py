"""Gradients through the port's fft engine against ``jax.grad``.

The losses are those of tests/test_differentiability.py: the sum of squares
of ``fft_convolve3d`` with respect to the kernel, and the mean squared
distance of one ``rl_view_step`` from its view with respect to psi (with
k2 = conj k1), and also with respect to λ and the weights, there and
through ``deconvolve`` on the fft and dft engines.  On the CPU the wrappers of K1-K3 run their plain versions
inside ``torch.autograd.Function``s (ops/elementwise.py); chip_smoke.py runs
the same gradients on the card, where K3's backward launches K3.

Tolerance: 1e-5 of max|g|.  Both sides are float32 FFT pipelines (pocketfft
and XLA's CPU FFT), whose sums are taken in different orders; the two
gradients agree to a few 1e-7 of max|g| here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmultiviewnative_torch.core import convolve as tconv
from libmultiviewnative_torch.core.fft import rfft3 as t_rfft3
from libmultiviewnative_torch.core.wrap import wrap_kernel as t_wrap
from libmultiviewnative_torch.deconv import rl as trl
from libmultiviewnative_torch.deconv.workspace import MultiViewData as TorchData
from libmultiviewnative_torch.ops import elementwise as ew
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel
from libmultiviewnative_tpu.core import convolve as jconv
from libmultiviewnative_tpu.core.fft import rfft3 as j_rfft3
from libmultiviewnative_tpu.core.wrap import wrap_kernel as j_wrap
from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
SHAPE = (8, 8, 8)


def _np(a):
    return a.detach().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0
    return float(np.abs(got - want).max() / np.abs(want).max())


def _image(seed):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def _kernel():
    return gaussian_kernel((3, 3, 3), 1.0)


@pytest.mark.parametrize("mode", ["circular", "linear"])
def test_grad_through_convolve_matches_jax(mode):
    x, k = _image(0), _kernel()
    want = jax.grad(lambda kk: jnp.sum(jconv.fft_convolve3d(jnp.asarray(x), kk, mode=mode) ** 2))(
        jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_()
    (tconv.fft_convolve3d(torch.from_numpy(x), kt, mode=mode) ** 2).sum().backward()
    assert _rel(kt.grad.numpy(), want) <= GRAD_RTOL


def test_grad_through_conjugate_product_matches_jax():
    """K3's backward with respect to k̂ under ``conj_k``: the gradient of a
    real kernel through x̂·conj(k̂)."""
    x, k = _image(1), _kernel()

    def loss(kk):
        k_hat = jnp.conj(j_rfft3(j_wrap(kk, SHAPE)))
        return jnp.sum(jconv.convolve_spectrum(jnp.asarray(x), k_hat) ** 2)

    want = jax.grad(loss)(jnp.asarray(k))
    kt = torch.from_numpy(k).requires_grad_()
    out = tconv.convolve_spectrum(torch.from_numpy(x), t_rfft3(t_wrap(kt, SHAPE)), conj_k=True)
    (out ** 2).sum().backward()
    assert _rel(kt.grad.numpy(), want) <= GRAD_RTOL


def _rl_inputs(seed):
    rng = np.random.default_rng(seed)
    psi = rng.gamma(2.0, 5.0, SHAPE).astype(np.float32)
    view = rng.gamma(2.0, 5.0, SHAPE).astype(np.float32)
    return psi, view, np.full(SHAPE, 0.5, np.float32), _kernel()[None]


@pytest.mark.parametrize("conj_k2", [False, True], ids=["k2-resolved", "conj_k2"])
@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_grad_through_rl_step_matches_jax(conj_k2, lam):
    """With respect to psi, through K3 (both products, one with conj_k2),
    K2 and K1 (Tikhonov when λ > 0)."""
    psi, view, w, k = _rl_inputs(2)

    def loss(p):
        k1 = jrl.prepare_spectra(jnp.asarray(k), SHAPE)[0]
        out = jrl.rl_view_step(p, jnp.asarray(view), k1, jnp.conj(k1), jnp.asarray(w), lam, 1e-4)
        return jnp.mean((out - view) ** 2)

    want = jax.grad(loss)(jnp.asarray(psi))
    k1 = trl.prepare_spectra(torch.from_numpy(k), SHAPE)[0]
    k2 = k1 if conj_k2 else k1.conj().resolve_conj()
    p = torch.from_numpy(psi).requires_grad_()
    out = trl.rl_view_step(p, torch.from_numpy(view), k1, k2, torch.from_numpy(w), lam, 1e-4,
                           conj_k2=conj_k2, out=p)
    assert out is not p
    ((out - torch.from_numpy(view)) ** 2).mean().backward()
    assert _rel(p.grad.numpy(), want) <= GRAD_RTOL
    np.testing.assert_array_equal(p.detach().numpy(), psi)  # out= was not written


def _cplx(rng, shape):
    return torch.complex(torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
                         torch.from_numpy(rng.normal(size=shape).astype(np.float32)))


@pytest.mark.parametrize("conj_k", [False, True])
def test_spectral_multiply_backward_matches_plain_autograd(conj_k):
    """Both operands, with k̂ broadcast over a batch axis of x̂: the sum over
    the batch in grad_k, and PyTorch's convention for complex gradients."""
    rng = np.random.default_rng(3)
    x, k = _cplx(rng, (3, 4, 6, 5)), _cplx(rng, (4, 6, 5))
    g = _cplx(rng, (3, 4, 6, 5))
    xs, ks = x.clone().requires_grad_(), k.clone().requires_grad_()
    ew.spectral_multiply(xs, ks, conj_k=conj_k).backward(g)
    xp, kp = x.clone().requires_grad_(), k.clone().requires_grad_()
    (xp * (kp.conj() if conj_k else kp)).backward(g)
    assert _rel(xs.grad, xp.grad) <= 1e-6 and _rel(ks.grad, kp.grad) <= 1e-6


@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_rl_update_and_quotient_backward_match_plain_autograd(lam):
    rng = np.random.default_rng(4)
    psi, integral, view = (torch.from_numpy(rng.gamma(2.0, 1.0, SHAPE).astype(np.float32))
                           for _ in range(3))
    g = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
    grads = []
    for rl_fn, q_fn in ((ew.rl_update, ew.quotient), (ew.rl_update_plain, ew.quotient_plain)):
        leaves = [t.clone().requires_grad_() for t in (psi, integral, view)]
        q = q_fn(leaves[2], leaves[1])
        rl_fn(leaves[0], q, 0.5, lam, 1e-4).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-6


def test_a_parameter_without_backward_raises():
    """λ and the weights, which had no backward before, now have K1's: the
    gradients of a 0-dim tensor λ and of a weight volume, a shared weight
    volume and a 0-dim weight against the plain version's autograd."""
    rng = np.random.default_rng(8)
    psi, integral = (torch.from_numpy(rng.gamma(2.0, 1.0, (2,) + SHAPE).astype(np.float32))
                     for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(2,) + SHAPE).astype(np.float32))
    for weights in (torch.full((2,) + SHAPE, 0.5), torch.full(SHAPE, 0.5), torch.tensor(0.5)):
        grads = []
        for rl_fn in (ew.rl_update, ew.rl_update_plain):
            w = weights.clone().requires_grad_()
            lam = torch.tensor(0.006, requires_grad=True)
            rl_fn(psi, integral, w, lam, 1e-4).backward(g)
            grads.append((w.grad, lam.grad))
        for got, want in zip(*grads):
            assert got.shape == want.shape
            assert _rel(got, want) <= 1e-6


def test_without_grad_rl_step_updates_psi_in_place():
    """No operand requires grad (the main path): out=psi is written and
    returned, and the values are those of a call without out=."""
    psi, view, w, k = (torch.from_numpy(a) for a in _rl_inputs(5))
    k1 = trl.prepare_spectra(k, SHAPE)[0]
    want = trl.rl_view_step(psi, view, k1, k1, w, 0.006, 1e-4, conj_k2=True)
    p = psi.clone()
    got = trl.rl_view_step(p, view, k1, k1, w, 0.006, 1e-4, conj_k2=True, out=p)
    assert got is p and not got.requires_grad
    torch.testing.assert_close(p, want, rtol=0, atol=0)


def _lam_w_inputs(seed, scalar_weights):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 5.0, (2,) + SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.25 * v) for v in range(2)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = rng.uniform(0.25, 0.75, (2,) + SHAPE).astype(np.float32)
    w = np.full((2,), 0.5, np.float32) if scalar_weights else w / w.sum(axis=0)
    psi = np.full(SHAPE, views.mean(), np.float32)
    return psi, views, k1, k2, w


def test_lam_and_weight_grads_of_rl_step_match_jax():
    """∂λ and ∂w of tests/test_differentiability.py's rl_view_step loss at
    λ = 0.006, against ``jax.grad`` in both arguments (F10)."""
    psi, view, w, k = _rl_inputs(2)

    def loss(lam, ww):
        k1 = jrl.prepare_spectra(jnp.asarray(k), SHAPE)[0]
        out = jrl.rl_view_step(jnp.asarray(psi), jnp.asarray(view), k1, jnp.conj(k1), ww, lam,
                               1e-4)
        return jnp.mean((out - view) ** 2)

    want_lam, want_w = jax.grad(loss, argnums=(0, 1))(jnp.float32(0.006), jnp.asarray(w))
    k1 = trl.prepare_spectra(torch.from_numpy(k), SHAPE)[0]
    lam = torch.tensor(0.006, requires_grad=True)
    wt = torch.from_numpy(w).requires_grad_()
    out = trl.rl_view_step(torch.from_numpy(psi), torch.from_numpy(view), k1, k1, wt, lam, 1e-4,
                           conj_k2=True)
    ((out - torch.from_numpy(view)) ** 2).mean().backward()
    assert _rel(lam.grad, want_lam) <= GRAD_RTOL
    assert _rel(wt.grad, want_w) <= GRAD_RTOL


def _jax_lam_w_grads(inputs, dtype, **kw):
    """``jax.grad`` in (λ = 0.006, w) of mean((deconvolve(psi, 2 it) - view_0)²)
    with every array of ``dtype``."""
    psi, views, k1, k2, w = (jnp.asarray(a, dtype) for a in inputs)

    def loss(lam, ww):
        out = jrl.deconvolve(psi, JaxData(views, k1, k2, ww), 2, lam=lam, **kw)
        return jnp.mean((out - views[0]) ** 2)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(0.006, dtype), w)


def _port_lam_w_grads(inputs, **kw):
    psi, views, k1, k2, w = (torch.from_numpy(a) for a in inputs)
    lam = torch.tensor(0.006, requires_grad=True)
    w.requires_grad_()
    out = trl.deconvolve(psi, TorchData(views, k1, k2, w), 2, lam=lam, **kw)
    ((out - views[0]) ** 2).mean().backward()
    return lam.grad, w.grad


@pytest.mark.parametrize("scalar_weights", [False, True], ids=["voxel-w", "scalar-w"])
@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_lam_and_weight_grads_of_deconvolve_match_jax(algorithm, scalar_weights):
    """∂λ and ∂w of mean((deconvolve(psi, 2 iterations) - view_0)²), with
    per-voxel or (V,) weights that require grad, against ``jax.grad``."""
    inputs = _lam_w_inputs(9, scalar_weights)
    want = _jax_lam_w_grads(inputs, jnp.float32, algorithm=algorithm)
    for got, ref in zip(_port_lam_w_grads(inputs, algorithm=algorithm), want):
        assert _rel(got, ref) <= GRAD_RTOL


def test_lam_and_weight_grads_of_the_simultaneous_order_match_jax_in_float64():
    """The same gradients in the simultaneous order, where psi's update is
    formed out of place under autograd.  ∂λ there sums terms that cancel:
    JAX's float32 gradient lies 2.1e-5 of it from JAX's float64 one, the
    port's 2.4e-6 (measured on the CPU).  So the reference is ``jax.grad`` in
    float64, at the same tolerance."""
    inputs = _lam_w_inputs(9, False)
    kw = dict(algorithm="fft", view_order="simultaneous")
    with jax.enable_x64(True):
        want = [np.asarray(g) for g in _jax_lam_w_grads(inputs, jnp.float64, **kw)]
    for got, ref in zip(_port_lam_w_grads(inputs, **kw), want):
        assert _rel(got, ref) <= GRAD_RTOL
