"""Batched volumes (psi shaped (B, Z, Y, X)) through the port's deconvolve
against the JAX package's batched runs, on the same numpy inputs: 2 views at
16³ with 5³ kernels, B = 2 or 3.

The JAX package takes leading batch axes on psi in every engine but fused
(``deconv/rl.py:364``, ``:391``); the port does so through K1 and K2 with
a shared (broadcast) weight volume or view, and K3 with a spectrum applied
to the batch (ops/elementwise.py), and on the fused engine too, one entry
at a time (``deconv/rl.py`` ``_deconvolve_fused``).  Views are (V, Z, Y, X), shared by the
batch, or (V, B, Z, Y, X); weights (V,), (V, Z, Y, X) or (V, B, Z, Y, X).

Tolerance: 1e-4 of max|psi| against JAX, as tests/test_torch_rl.py (two FFT
libraries, per-transform differences compounding over the view steps); the
convergence deltas at rtol 1e-3, as there.  Against the port's own
single-volume runs: 1e-6 of max|psi| (the same kernels on the same values;
a batched transform may sum in another order than a single one), and
bitwise on the fft engine's sequential order, which transforms a batch one
entry at a time, and on the fused engine, which runs one.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import dispatch as jdispatch, rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_tpu.models import RichardsonLucy as JaxRL
from libmultiviewnative_torch.deconv import dispatch, rl
from libmultiviewnative_torch.deconv.workspace import (
    MultiViewData,
    WeightNormalizationWarning,
    check_simultaneous_weights,
)
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.models import RichardsonLucy
from libmultiviewnative_torch.ops import elementwise as ew
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-4
SELF_RTOL = 1e-6
SHAPE = (16, 16, 16)
V = 2
B = 3
KW = dict(num_iterations=2, lam=0.006, min_value=1e-4)


def _inputs(views="shared", weights="voxel", batch=B, seed=0):
    """psi0 (batch, Z, Y, X), views, kernels and weights of the requested
    forms; the weights sum to 1 over the views."""
    rng = np.random.default_rng(seed)
    vshape = (V,) + ((batch,) if views == "batched" else ()) + SHAPE
    vs = rng.gamma(2.0, 20.0, vshape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(V)])
    k2 = np.stack([np.flip(k).copy() for k in k1])
    if weights == "scalar":
        w = np.full((V,), 1.0 / V, np.float32)
    else:
        wshape = (V,) + ((batch,) if weights == "batched" else ()) + SHAPE
        w = rng.uniform(0.5, 1.5, wshape).astype(np.float32)
        w /= w.sum(axis=0, keepdims=True)
    psi0 = (vs.mean() * rng.uniform(0.8, 1.2, (batch,) + SHAPE)).astype(np.float32)
    return psi0, vs, k1, k2, w


def _jdata(arrays):
    return JaxData(*(jnp.asarray(a) for a in arrays[1:]))


def _tdata(arrays):
    return multiview_data_from_numpy(*arrays[1:], device="cpu")


def _jax(arrays, **kw):
    # deconvolve_jit donates psi: a fresh array per call
    return np.asarray(jrl.deconvolve_jit(jnp.asarray(arrays[0].copy()), _jdata(arrays), **kw))


def _port(arrays, **kw):
    return rl.deconvolve(torch.from_numpy(arrays[0]), _tdata(arrays), **kw)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
def test_engines_match_jax(algorithm, view_order):
    arrays = _inputs()
    kw = dict(KW, algorithm=algorithm, view_order=view_order)
    got = _port(arrays, **kw).numpy()
    assert got.shape == (B,) + SHAPE
    assert _rel(got, _jax(arrays, **kw)) <= RTOL


@pytest.mark.parametrize("weights", ["voxel", "scalar", "batched"])
@pytest.mark.parametrize("views", ["shared", "batched"])
def test_views_and_weights_forms_match_jax(views, weights):
    arrays = _inputs(views, weights)
    kw = dict(KW, algorithm="fft")
    assert _rel(_port(arrays, **kw).numpy(), _jax(arrays, **kw)) <= RTOL


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
def test_adjoint_kernel2_matches_jax(algorithm):
    arrays = _inputs(weights="scalar")
    kw = dict(KW, algorithm=algorithm, adjoint_kernel2=True)
    assert _rel(_port(arrays, **kw).numpy(), _jax(arrays, **kw)) <= RTOL


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
def test_track_convergence_over_the_batch_matches_jax(view_order):
    """The deltas are taken over the whole batch, as JAX's are
    (``rl.py:541-549``)."""
    arrays = _inputs(views="batched")
    kw = dict(KW, num_iterations=3, algorithm="fft", view_order=view_order)
    psi, deltas = _port(arrays, track_convergence=True, **kw)
    jpsi, jdeltas = jrl.deconvolve(jnp.asarray(arrays[0]), _jdata(arrays),
                                   track_convergence=True, **kw)
    assert deltas.shape == (3,)
    assert _rel(psi.numpy(), jpsi) <= RTOL
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas), rtol=1e-3)
    psi_h, deltas_h = rl.deconvolve_with_history(torch.from_numpy(arrays[0]), _tdata(arrays),
                                                 **kw)
    jpsi_h, jdeltas_h = jrl.deconvolve_with_history(jnp.asarray(arrays[0]), _jdata(arrays), **kw)
    assert _rel(psi_h.numpy(), jpsi_h) <= RTOL
    np.testing.assert_allclose(deltas_h.numpy(), np.asarray(jdeltas_h), rtol=1e-3)


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
def test_fused_batch_deltas_match_the_fft_batch(view_order):
    """The fused engine runs a batch entry by entry, and still reports one
    delta a sweep over the whole batch: the fft batch's, at rtol 1e-3."""
    arrays = _inputs(views="batched")
    kw = dict(KW, num_iterations=3, view_order=view_order, track_convergence=True)
    psi, deltas = _port(arrays, algorithm="fused", **kw)
    fpsi, fdeltas = _port(arrays, algorithm="fft", **kw)
    assert deltas.shape == (3,)
    assert _rel(psi.numpy(), fpsi.numpy()) <= RTOL
    np.testing.assert_allclose(deltas.numpy(), fdeltas.numpy(), rtol=1e-3)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_prepared_matches_jax(algorithm):
    arrays = _inputs()
    jdata, data = _jdata(arrays), _tdata(arrays)
    jprep = jrl.prepare_workspace(jdata, SHAPE, algorithm=algorithm)
    prep = rl.prepare_workspace(data, SHAPE, algorithm=algorithm)
    want = jrl.deconvolve_prepared(jnp.asarray(arrays[0]), jdata, jprep, **KW)
    got = rl.deconvolve_prepared(torch.from_numpy(arrays[0]), data, prep, **KW)
    assert _rel(got.numpy(), want) <= RTOL


def test_deconvolve_auto_and_the_model_match_jax(capsys, monkeypatch):
    """The in-core rung serves the batch in both packages (on the CPU the
    ``auto`` engine is dft there), and ``RichardsonLucy.run`` with a batched
    psi0 goes through it."""
    arrays = _inputs(views="batched", weights="scalar", batch=2)
    jdata, data = _jdata(arrays), _tdata(arrays)
    monkeypatch.setenv("LMVN_TRACE", "1")
    got = dispatch.deconvolve_auto(torch.from_numpy(arrays[0]), data, 2, lam=0.006, device="cpu")
    assert "dispatch: in-core on one device" in capsys.readouterr().out
    want = jdispatch.deconvolve_auto(jnp.asarray(arrays[0]), jdata, 2, lam=0.006)
    assert _rel(got.numpy(), want) <= RTOL
    model = RichardsonLucy(num_iterations=2, lambda_=0.006, device="cpu")
    jmodel = JaxRL(num_iterations=2, lambda_=0.006)
    got_m = model.run(data, torch.from_numpy(arrays[0]))
    want_m = jmodel.run(jdata, jnp.asarray(arrays[0]))
    assert _rel(got_m.numpy(), want_m) <= RTOL
    np.testing.assert_array_equal(got_m.numpy(), got.numpy())


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct", "fused"])
def test_each_entry_is_the_single_volume_run(algorithm, view_order):
    """Entry b of a batched run is the run on entry b, with the views and
    weights of entry b (here batched views, per-entry weights).  The fft
    engine's sequential order transforms a batch one entry at a time, and
    the fused engine runs one entry at a time in either order, so there it
    is bitwise."""
    arrays = _inputs(views="batched", weights="batched")
    kw = dict(KW, algorithm=algorithm, view_order=view_order)
    got = _port(arrays, **kw).numpy()
    for b in range(B):
        one = (arrays[0][b], arrays[1][:, b], arrays[2], arrays[3], arrays[4][:, b])
        want = _port(one, **kw).numpy()
        assert _rel(got[b], want) <= SELF_RTOL, b
        if algorithm == "fused" or (algorithm == "fft" and view_order == "sequential"):
            np.testing.assert_array_equal(got[b], want)


def test_two_batch_axes_and_shared_views():
    """psi (2, 2, Z, Y, X) against shared views and scalar weights: the
    batch may have more than one axis."""
    arrays = _inputs(weights="scalar", batch=4)
    psi4 = arrays[0].reshape((2, 2) + SHAPE)
    got = rl.deconvolve(torch.from_numpy(psi4), _tdata(arrays), algorithm="fft", **KW)
    flat = _port(arrays, algorithm="fft", **KW)
    assert got.shape == (2, 2) + SHAPE
    np.testing.assert_array_equal(got.reshape(flat.shape).numpy(), flat.numpy())


# (views, weights, order, prepared, batch shape) of a fused batch
FUSED_CASES = [
    (v, w, "sequential", False, (B,)) for v in ("shared", "batched")
    for w in ("voxel", "scalar", "batched")
] + [
    ("shared", "voxel", "simultaneous", False, (B,)),
    ("batched", "batched", "simultaneous", False, (B,)),
    ("shared", "voxel", "carried", False, (B,)),
    ("batched", "scalar", "carried", False, (B,)),
    ("shared", "voxel", "sequential", True, (B,)),
    ("batched", "batched", "carried", True, (B,)),
    ("shared", "scalar", "sequential", False, (2, 2)),
    ("batched", "batched", "simultaneous", False, (2, 2)),
]


@pytest.mark.parametrize("views, weights, order, prepared, bshape", FUSED_CASES, ids=str)
def test_fused_batch_is_each_entry_run_alone_where_jax_refuses(monkeypatch, views, weights,
                                                               order, prepared, bshape):
    """JAX's fused engine takes one volume and refuses a batch; the port's
    runs the entries one at a time, so entry b of a batched
    ``algorithm="fused"`` call is, bitwise, the single-volume fused call on
    entry b with its views and weights.  "carried" is the sequential order
    under ``LMVN_FUSED_CARRY=1``; ``prepared`` takes spectra from
    ``prepare_workspace``; (2, 2) is a batch of two axes, its views and
    weights (V, 2, 2, Z, Y, X) where batched."""
    nb = math.prod(bshape)
    arrays = _inputs(views, weights, batch=nb)
    shape_b = lambda a: a.reshape(a.shape[:1] + bshape + SHAPE)
    arrays = (arrays[0].reshape(bshape + SHAPE),
              shape_b(arrays[1]) if views == "batched" else arrays[1], arrays[2], arrays[3],
              shape_b(arrays[4]) if weights == "batched" else arrays[4])
    with pytest.raises(ValueError, match="single volumes"):
        jrl.deconvolve(jnp.asarray(arrays[0]), _jdata(arrays), 1, algorithm="fused")
    if order == "carried":
        monkeypatch.setenv("LMVN_FUSED_CARRY", "1")
    kw = dict(KW, view_order="simultaneous" if order == "simultaneous" else "sequential")
    data = _tdata(arrays)
    if prepared:
        prep = rl.prepare_workspace(data, SHAPE, algorithm="fused")
        got = rl.deconvolve_prepared(torch.from_numpy(arrays[0]), data, prep, **kw)
    else:
        got = _port(arrays, algorithm="fused", **kw)
    assert got.shape == bshape + SHAPE
    flat = got.reshape((nb,) + SHAPE).numpy()
    for b in range(nb):
        entry = lambda a: a.reshape((V, nb) + SHAPE)[:, b]
        one = (arrays[0].reshape((nb,) + SHAPE)[b],
               entry(arrays[1]) if views == "batched" else arrays[1], arrays[2], arrays[3],
               entry(arrays[4]) if weights == "batched" else arrays[4])
        np.testing.assert_array_equal(flat[b], _port(one, algorithm="fused", **kw).numpy())


def test_cuda_rule_gives_a_batch_what_it_gives_one_volume(monkeypatch):
    """The CPU rule never gives fused.  The CUDA rule gives fused at 256³
    and fft to a streamed rung's chunk (``chunk=True``); a batch is resolved
    as one of its volumes, without ``chunk``.  Forced here for CPU tensors,
    it sends a batch to fused in ``deconvolve``, bitwise the explicit fused
    batch, and the ladder's estimate counts the same engine's spectra for a
    batch as for one volume, and for the further entry its input and output."""
    arrays = _inputs(batch=2)
    assert rl.resolve_algorithm("auto", SHAPE, "cpu") == "dft"
    assert rl.resolve_algorithm("auto", SHAPE, "cpu", chunk=True) == "dft"
    assert rl.resolve_algorithm("auto", (256,) * 3, "cuda", chunk=True) == "fft"
    assert rl.resolve_algorithm("auto", (256,) * 3, "cuda") == "fused"
    picks = []
    real = rl.resolve_algorithm

    def cuda_rule(algorithm, spatial, device=None, chunk=False):
        picks.append("fft" if chunk else "fused")
        return real(algorithm, spatial, device, chunk) if algorithm != "auto" else picks[-1]

    monkeypatch.setattr(rl, "resolve_algorithm", cuda_rule)
    monkeypatch.setattr(dispatch, "resolve_algorithm", cuda_rule)
    got = _port(arrays, algorithm="auto", **KW)
    assert picks == ["fused"]
    data = _tdata(arrays)
    est = [dispatch.estimate_workspace_bytes(data, "auto", "cpu", batch=n) for n in (1, 2)]
    assert picks == ["fused"] * 3
    # one entry at a time: the second entry adds its input and its output alone
    assert est[1] - est[0] == 2 * 4 * math.prod(SHAPE)
    monkeypatch.setattr(rl, "resolve_algorithm", real)
    np.testing.assert_array_equal(got.numpy(), _port(arrays, algorithm="fused", **KW).numpy())
    fft = _port(arrays, algorithm="fft", **KW)
    assert _rel(got.numpy(), fft.numpy()) <= RTOL


def test_r8_the_estimate_counts_the_batch(monkeypatch):
    """R8 (ROADMAP queue 3): JAX's estimate counts psi as 8 volumes and the
    views and weights as 2V whatever their batch; the port's grows with B.
    A batched request that does not fit raises, naming the batch, where JAX
    takes it in-core."""
    vol = 4 * math.prod(SHAPE)
    one, two = _inputs(batch=1), _inputs(views="batched", weights="batched", batch=3)
    want_one = jdispatch.estimate_workspace_bytes(_jdata(one), "fft")
    assert dispatch.estimate_workspace_bytes(_tdata(one), "fft", "cpu") == want_one
    assert jdispatch.estimate_workspace_bytes(_jdata(two), "fft") == want_one
    est = dispatch.estimate_workspace_bytes(_tdata(two), "fft", "cpu", batch=3)
    assert est == want_one + 2 * V * 2 * vol + 8 * 2 * vol
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: int(est / 0.9) - 1)
    with pytest.raises(ValueError, match="a batch of 3 volumes"):
        dispatch.deconvolve_auto(torch.from_numpy(two[0]), _tdata(two), 1, algorithm="fft",
                                 device="cpu")
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: int(est / 0.9) + 8)
    got = dispatch.deconvolve_auto(torch.from_numpy(two[0]), _tdata(two), 1, algorithm="fft",
                                   device="cpu")
    assert got.shape == (3,) + SHAPE


def test_simultaneous_weights_check_takes_a_batch():
    w = torch.full((V, 2) + SHAPE, 1.0 / V)
    check_simultaneous_weights(w)
    w[1, 1] = 1.0
    with pytest.warns(WeightNormalizationWarning):
        check_simultaneous_weights(w)
    data = MultiViewData(torch.ones((V, 2) + SHAPE), torch.ones(V, 3, 3, 3),
                         torch.ones(V, 3, 3, 3), w)
    assert data.spatial_shape == SHAPE and data.num_views == V


# ---- K1 and K2 with a shared operand, on the CPU (their plain versions) ----


def _rand(rng, shape, lo, hi):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(3,) + SHAPE, (3, 7, 9, 13), (2, 2, 4, 4, 4)], ids=str)
@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_k1_and_k2_broadcast_equal_their_plain_versions(shape, lam):
    rng = np.random.default_rng(5)
    psi, integral = _rand(rng, shape, 1.0, 100.0), _rand(rng, shape, -0.2, 2.0)
    w, view = _rand(rng, shape[-3:], 0.0, 0.5), _rand(rng, shape[-3:], 0.0, 200.0)
    want = ew.rl_update_plain(psi, integral, w.expand(shape), lam, 1e-4)
    out = psi.clone()
    got = ew.rl_update(out, integral, w, lam, 1e-4, out=out)
    assert got is out
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want_q = ew.quotient_plain(view.expand(shape), integral)
    got_q = ew.quotient(view, integral, out=integral.clone())
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=0)
    assert set(ew.launches.values()) == {0}


def test_k1_and_k2_refuse_an_operand_that_is_not_a_suffix():
    psi = torch.ones((2,) + SHAPE)
    with pytest.raises(ValueError, match="suffix"):
        ew.rl_update(psi, psi, torch.ones((3,) + SHAPE), 0.0, 1e-4)
    with pytest.raises(ValueError, match="suffix"):
        ew.quotient(torch.ones((3,) + SHAPE), psi)
    with pytest.raises(ValueError, match="suffix"):
        ew.quotient(psi, torch.ones(SHAPE))  # the integral is never the shared one


def test_k1_and_k2_autograd_sums_the_shared_operand():
    """The shared weight volume's and view's gradients are summed over the
    batch, as plain broadcasting autograd gives them."""
    rng = np.random.default_rng(6)
    shape = (3, 4, 5, 6)
    psi, integral = _rand(rng, shape, 1.0, 10.0), _rand(rng, shape, 0.5, 2.0)
    w, view = _rand(rng, shape[1:], 0.1, 0.9), _rand(rng, shape[1:], 1.0, 5.0)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    grads = []
    for rl_fn, q_fn in ((ew.rl_update, ew.quotient), (ew.rl_update_plain, ew.quotient_plain)):
        leaves = [t.clone().requires_grad_() for t in (psi, integral, w, view)]
        lam = torch.tensor(0.006, requires_grad=True)
        q = q_fn(leaves[3], leaves[1])
        rl_fn(leaves[0], q, leaves[2], lam, 1e-4).backward(g)
        grads.append([t.grad for t in leaves] + [lam.grad])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    assert grads[0][2].shape == shape[1:] and grads[0][3].shape == shape[1:]
