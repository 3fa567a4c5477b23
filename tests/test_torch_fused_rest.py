"""The rest of the port's fused engine against the JAX package's, run in
interpret mode at ``precision="highest"`` as tests/test_pallas_ops.py runs
it: K5 pass BF, K7 pass C, K10 pass CUA, the standalone fused convolve, the
dense spectrum forwarding and the carried chain (``LMVN_FUSED_CARRY=1``).

On the CPU every pass wrapper runs its plain PyTorch version; the CUDA
kernels (ops/csrc/fused.cu, fft_stage.cuh) are held against the same plain versions on the
card by chip_smoke.py (phases 14-17).

Tolerances, as tests/test_torch_fused.py states them:
* each pass and each spectrum forwarding: max|diff| <= 1e-5 · max|ref| over
  the (re, im) pair; K10's psi' and its spectrum pair are held each against
  its own maximum, psi' at λ > 0 with the Tikhonov slack 4 ulp(1)/λ;
* the convolve: 1e-5 of max|ref|;
* the carried driver: 1e-4 of max|psi| against JAX's carried chain (as the
  plain slice in tests/test_torch_fused.py), and bitwise against the port's
  plain chain, which runs the same plain passes on the same values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd
from libmultiviewnative_torch.core.wrap import wrap_kernel
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

PASS_RTOL = 1e-5
SLICE_RTOL = 1e-4
LAM = 0.006
TIKHONOV_ATOL = 4 * float(np.finfo(np.float32).eps) / LAM
# (Z, Y, X): dense stages; 2-way split z and y stages
SHAPES = [(16, 24, 32), (256, 256, 16)]
SHAPE = (16, 24, 32)
V = 2
RUN = dict(interpret=True, precision="highest")


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return tuple(np.asarray(e) for e in x) if isinstance(x, tuple) else np.asarray(x)


def _rel(got, want, atol=0.0):
    """max|got - want| over an output or an (re, im) pair, against max|want|."""
    if isinstance(want, (tuple, list)):
        got = np.concatenate([np.asarray(g).ravel() for g in got])
        want = np.concatenate([np.asarray(w).ravel() for w in want])
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.maximum(np.abs(got - want) - atol, 0.0)) / np.abs(want).max())


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def jax_rest(request):
    """Inputs and the JAX package's interpret-mode outputs at one shape:
    pass BF of a wrapped kernel's pass A, pass C of a pass-B spectrum, and
    pass CUA of it with per-voxel weights at λ = 0.006 and a scalar weight
    at λ = 0."""
    shape = request.param
    Z, Y, X = shape
    rng = np.random.default_rng(5)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    w = rng.uniform(0.0, 0.5, (Z, X, Y)).astype(np.float32)
    k = gaussian_kernel((5, 5, 5), 1.2)
    kt = np.ascontiguousarray(wrap_kernel(_t(k), shape).numpy().transpose(0, 2, 1))
    plan = fd.make_fused_plan(shape)
    uk = fd._run_pass_a(jnp.asarray(kt), plan, 8, **RUN)
    kspec = fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest")
    u = fd._run_pass_a(jnp.asarray(psi), plan, 8, **RUN)
    v = fd._run_pass_b(*u, *kspec, plan, **RUN)
    cua = {
        "voxel-w": fd._run_pass_cua(*v, jnp.asarray(psi), jnp.asarray(w), plan, 8, LAM, 1e-4,
                                    **RUN),
        "scalar-w": fd._run_pass_cua(*v, jnp.asarray(psi), jnp.asarray(0.25), plan, 8, 0.0, 1e-4,
                                     **RUN),
    }
    return dict(
        shape=shape, psi=psi, w=w, uk=_np(uk), v=_np(v),
        bf=_np(fd._run_pass_bf(*uk, plan, **RUN)),
        c=_np(fd._run_pass_c(*v, plan, 8, **RUN)),
        cua={name: _np(out) for name, out in cua.items()},
        plan=fp.make_fused_plan(shape),
    )


def test_pass_bf_matches_jax(jax_rest):
    got = fu.pass_bf(*map(_t, jax_rest["uk"]), jax_rest["plan"])
    assert _rel(got, jax_rest["bf"]) <= PASS_RTOL
    kx = jax_rest["plan"].kxh
    assert all(not g[kx:].any() for g in got)  # pad rows


def test_pass_c_matches_jax(jax_rest):
    v = tuple(map(_t, jax_rest["v"]))
    got = fu.pass_c(*v, jax_rest["plan"])
    assert _rel(got, jax_rest["c"]) <= PASS_RTOL


@pytest.mark.parametrize("case", ["voxel-w", "scalar-w"])
def test_pass_cua_matches_jax(jax_rest, case):
    """psi' and pass A of psi', also in place (psi' over psi, the spectrum
    over v), as the carried chain runs it."""
    plan, v = jax_rest["plan"], tuple(map(_t, jax_rest["v"]))
    psi = _t(jax_rest["psi"])
    weights, lam = (_t(jax_rest["w"]), LAM) if case == "voxel-w" else (0.25, 0.0)
    want_psi, *want_u = jax_rest["cua"][case]
    new, u = fu.pass_cua(*v, psi, weights, plan, lam, 1e-4)
    assert _rel(new, want_psi, TIKHONOV_ATOL if lam else 0.0) <= PASS_RTOL
    assert _rel(u, want_u) <= PASS_RTOL
    p, buf = psi.clone(), tuple(x.clone() for x in v)
    got_psi, got_u = fu.pass_cua(*buf, p, weights, plan, lam, 1e-4, out=p, u_out=buf)
    assert got_psi is p and got_u[0] is buf[0] and got_u[1] is buf[1]
    assert torch.equal(p, new) and all(torch.equal(a, b) for a, b in zip(buf, u))
    # K10 is K9 followed by K4
    c = fu.plan_tensors(plan, "cpu")
    cu = fu.pass_cu_plain(*v, psi, weights, c, lam, 1e-4)
    assert torch.equal(new, cu) and all(torch.equal(a, b) for a, b in zip(u, fu.pass_a_plain(cu, c)))


@pytest.mark.parametrize("conj_k", [False, True], ids=["kernel", "conj"])
def test_fused_convolve_matches_jax(conj_k):
    """fused_convolve_transposed and fused_convolve_spectrum against JAX's;
    conj_k against the negated spectrum, as JAX's adjoint materialises it."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0.0, 10.0, SHAPE).astype(np.float32)
    k = gaussian_kernel((5, 5, 5), 1.0)
    k_re, k_im = map(np.asarray, fd.kernel_spectrum_fused(jnp.asarray(k), SHAPE, precision="highest"))
    jk_im = -k_im if conj_k else k_im
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    want_t = fd.fused_convolve_transposed(jnp.asarray(xt), jnp.asarray(k_re), jnp.asarray(jk_im),
                                          **RUN)
    got_t = fu.fused_convolve_transposed(_t(xt), _t(k_re), _t(k_im), conj_k=conj_k)
    assert _rel(got_t, want_t) <= PASS_RTOL
    want = fd.fused_convolve_spectrum(jnp.asarray(x), jnp.asarray(k_re), jnp.asarray(jk_im), **RUN)
    got = fu.fused_convolve_spectrum(_t(x), _t(k_re), _t(k_im), conj_k=conj_k)
    assert got.shape == SHAPE and got.is_contiguous()
    assert _rel(got, want) <= PASS_RTOL


def test_dense_kernel_spectrum_matches_jax():
    """A kernel z-extent of 9 at Z = 16 takes the dense branch (pass A, then
    pass BF) in both packages; where both branches serve a kernel, they
    agree."""
    k9 = gaussian_kernel((9, 5, 7), 1.0)
    assert not fu.sparse_prep_ok(9, SHAPE[0])
    want = fd.kernel_spectrum_fused(jnp.asarray(k9), SHAPE, precision="highest")
    got = fu.kernel_spectrum_fused(_t(k9), SHAPE)
    assert all(g.is_contiguous() for g in got)
    assert _rel(got, want) <= PASS_RTOL
    k5 = _t(gaussian_kernel((5, 5, 5), 1.0))
    assert fu.sparse_prep_ok(5, SHAPE[0])
    assert _rel(fu._spectrum_dense(k5, SHAPE), fu._spectrum_sparse(k5, SHAPE)) <= PASS_RTOL


@pytest.mark.parametrize("setting", ["allow_tf32", "fp32_precision", "medium"])
def test_sparse_spectrum_contraction_runs_in_fp32(monkeypatch, setting):
    """The z-sparse branch's einsum runs at full fp32 matmul precision
    whatever the caller set (the JAX branch pins HIGHEST), and the caller's
    setting is back afterwards.  chip_smoke.py holds the values on the card."""
    matmul = torch.backends.cuda.matmul
    before = (matmul.fp32_precision, torch.get_float32_matmul_precision())
    einsum, seen = torch.einsum, []

    def spy(*a):
        seen.append((matmul.fp32_precision, torch.get_float32_matmul_precision()))
        return einsum(*a)

    monkeypatch.setattr(torch, "einsum", spy)
    k5 = _t(gaussian_kernel((5, 5, 5), 1.0))
    try:
        if setting == "allow_tf32":
            matmul.allow_tf32 = True
        elif setting == "fp32_precision":
            matmul.fp32_precision = "tf32"
        else:
            torch.set_float32_matmul_precision("medium")
        caller = matmul.fp32_precision
        fu._spectrum_sparse(k5, SHAPE)
        assert matmul.fp32_precision == caller
    finally:
        torch.set_float32_matmul_precision(before[1])
        matmul.fp32_precision = before[0]
    assert seen and all(s == ("ieee", "highest") for s in seen)


def _inputs(scalar_weights, seed=0):
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


@pytest.mark.parametrize(
    "adjoint", [False, True], ids=["per-voxel-weights", "adjoint-scalar-weights-prepared"]
)
def test_carried_deconvolve_matches_jax_and_plain_chain(monkeypatch, adjoint):
    """LMVN_FUSED_CARRY=1: the port's carried chain (with history) against
    JAX's carried chain, and bitwise against the port's plain chain."""
    psi0, views, k1, k2, w = _inputs(scalar_weights=adjoint)
    kw = dict(num_iterations=2, lam=LAM, min_value=1e-4)
    monkeypatch.setenv("LMVN_FUSED_CARRY", "1")
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    want, want_deltas = map(np.asarray, jrl.deconvolve_with_history(
        jnp.asarray(psi0), jdata, algorithm="fused", adjoint_kernel2=adjoint, **kw))
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    psi = torch.from_numpy(psi0)
    assert rl._carry_enabled()
    if adjoint:
        prepared = rl.prepare_workspace(data, SHAPE, algorithm="fused", adjoint_kernel2=True)
        carried = rl.deconvolve(psi, data, prepared=prepared, track_convergence=True, **kw)
    else:
        carried = rl.deconvolve_with_history(psi, data, algorithm="fused", **kw)
    assert _rel(carried[0].numpy(), want) <= SLICE_RTOL
    np.testing.assert_allclose(carried[1].numpy(), want_deltas, rtol=1e-3)
    np.testing.assert_array_equal(psi.numpy(), psi0)  # the caller's psi is not written
    monkeypatch.setenv("LMVN_FUSED_CARRY", "0")
    assert not rl._carry_enabled()
    plain = rl.deconvolve_with_history(psi, data, algorithm="fused", adjoint_kernel2=adjoint, **kw)
    assert torch.equal(carried[0], plain[0]) and torch.equal(carried[1], plain[1])


def test_carry_enabled_reads_the_environment(monkeypatch):
    """Only LMVN_FUSED_CARRY=1 selects the carried chain: the fp32 default of
    the JAX package is the plain one."""
    monkeypatch.delenv("LMVN_FUSED_CARRY", raising=False)
    assert not rl._carry_enabled()
    for value, want in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("LMVN_FUSED_CARRY", value)
        assert rl._carry_enabled() is want


def test_rest_wrappers_never_reach_plain_on_non_cpu(monkeypatch):
    """Only a CPU tensor reaches a plain pass: another device raises."""

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("pass_bf_plain", "pass_c_plain", "pass_cua_plain"):
        monkeypatch.setattr(fu, name, boom)
    fu.reset_launches()
    plan = fp.make_fused_plan((8, 8, 8))
    m = torch.empty((8, 8, 8), device="meta")
    s = torch.empty((plan.kxp, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_bf(s, s, plan)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_c(s, s, plan)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_cua(s, s, m, 0.5, plan, 0.0, 1e-4)
    c = torch.zeros((plan.kxp, 8, 8))
    with pytest.raises(ValueError, match="shape"):
        fu.pass_c(c, c[:, :4].contiguous(), plan)
    with pytest.raises(ValueError, match="shape"):
        fu.pass_cua(c, c, torch.zeros((8, 8, 8)), 0.5, plan, 0.0, 1e-4, u_out=(c, c[:4]))
    assert set(fu.launches.values()) == {0}
