"""The port's fused engine (libmultiviewnative_torch.ops.fused and the
``algorithm="fused"`` driver) against the JAX package's fused engine, run in
interpret mode at ``precision="highest"`` as tests/test_pallas_ops.py runs it.

On the CPU every pass wrapper runs its plain PyTorch version; the CUDA
kernels (ops/csrc/fused.cu, fft_stage.cuh) are held against the same plain versions on the
card by chip_smoke.py.

Tolerances:
* plan constants: bitwise (the same numpy expressions);
* each pass and the spectrum forwarding: max|diff| <= 1e-5 · max|ref| over
  the (re, im) pair.  Both sides are fp32 matmul chains summing in another
  order; measured here at most 1.5e-6 (pass B at Z = 256).  Pass CU at
  λ > 0 adds the Tikhonov slack of chip_smoke.py (4 ulp(1)/λ absolute), for
  the sqrt in sqrt(1 + 2λv) - 1 (see tests/test_torch_kernels.py);
* the whole slice against ``deconvolve_jit(algorithm="fused")``: 1e-4 of
  max|psi|; measured 6.9e-7 (per-voxel weights) and 8.8e-7 (adjoint, scalar
  weights).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import rl as jrl
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd
from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.interop import multiview_data_from_numpy, prepared_from_jax
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

PASS_RTOL = 1e-5
SLICE_RTOL = 1e-4
LAM = 0.006
# (Z, Y, X): dense stages; a 2-way split y stage; a 2-way split z stage
SHAPES = [(16, 24, 32), (16, 256, 16), (256, 16, 16)]
SHAPE = (16, 24, 32)  # the slice
V = 2


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want, atol=0.0):
    """max|got - want| over an output or an (re, im) pair, against max|want|."""
    if isinstance(want, (tuple, list)):
        got = np.concatenate([np.asarray(g).ravel() for g in got])
        want = np.concatenate([np.asarray(w).ravel() for w in want])
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.maximum(np.abs(got - want) - atol, 0.0)) / np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_constants_bitwise(shape):
    j, p = fd.make_fused_plan(shape), fp.make_fused_plan(shape)
    assert (p.shape, p.kxh, p.kxp) == (j.shape, j.kxh, j.kxp)
    assert np.array_equal(p.fxp, j.fxp) and np.array_equal(p.bxp, j.bxp)
    for js, ps in ((j.sy, p.sy), (j.sz, p.sz)):
        assert (ps.R, ps.M) == (js.R, js.M)
        for name in ("wf", "wi", "twf", "twi"):
            for a, b in zip(getattr(ps, name), getattr(js, name), strict=True):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(ps.omf, js.omf) and np.array_equal(ps.omi, js.omi)
    n, split = shape[1], (j.sy.R, j.sy.M)
    assert np.array_equal(fp.split_perm(n, split), fd.split_perm(n, split))


@pytest.mark.parametrize("shape", [(8, 600, 520), (264, 8, 16), (520, 16, 8)], ids=str)
def test_plan_constants_bitwise_by_row_blocks(shape):
    """The port builds its dense stage matrices by blocks of 256 rows on a
    thread pool; with unsplit stages longer than a block (y 600 and z 264,
    520 in 3 and 2 blocks, x 261 frequencies in 2) every constant is still
    bitwise the JAX package's."""
    test_plan_constants_bitwise(shape)


def test_plan_forms_not_ported_raise():
    for kw in (dict(fold_x=True), dict(twfold=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fp.make_fused_plan((16, 16, 16), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fp._make_split(256, (2, 128), cmul="stacked")


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def jax_passes(request):
    """Inputs and the JAX package's interpret-mode outputs of every pass at
    one shape: pass A of psi, pass B of that with kernel1's spectrum, CQA of
    that against the view, CU of that at λ = 0 and λ = 0.006."""
    shape = request.param
    Z, Y, X = shape
    rng = np.random.default_rng(2)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    view = rng.uniform(1.0, 200.0, (Z, X, Y)).astype(np.float32)
    w = rng.uniform(0.0, 0.5, (Z, X, Y)).astype(np.float32)
    k = gaussian_kernel((5, 5, 5), 1.2)
    plan = fd.make_fused_plan(shape)
    run = dict(interpret=True, precision="highest")
    kspec = fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest")
    a = fd._run_pass_a(jnp.asarray(psi), plan, 8, run["interpret"], run["precision"])
    b = fd._run_pass_b(*a, *kspec, plan, **run)
    cqa = fd._run_pass_cqa(*b, jnp.asarray(view), plan, 8, **run)
    cu = {
        lam: fd._run_pass_cu(*b, jnp.asarray(psi), jnp.asarray(w), plan, 8, lam, 1e-4, **run)
        for lam in (0.0, LAM)
    }
    np_ = lambda x: tuple(np.asarray(e) for e in x) if isinstance(x, tuple) else np.asarray(x)
    return dict(
        shape=shape, psi=psi, view=view, w=w, k=k, kspec=np_(kspec), a=np_(a), b=np_(b),
        cqa=np_(cqa), cu={lam: np_(v) for lam, v in cu.items()},
        plan=fp.make_fused_plan(shape),
    )


def test_kernel_spectrum_matches_jax(jax_passes):
    got = fu.kernel_spectrum_fused(_t(jax_passes["k"]), jax_passes["shape"])
    assert all(g.is_contiguous() for g in got)
    assert _rel(got, jax_passes["kspec"]) <= PASS_RTOL


def test_pass_a_matches_jax(jax_passes):
    got = fu.pass_a(_t(jax_passes["psi"]), jax_passes["plan"])
    assert _rel(got, jax_passes["a"]) <= PASS_RTOL
    kx = jax_passes["plan"].kxh
    assert all(not g[kx:].any() for g in got)  # pad rows


@pytest.mark.parametrize("in_place", [False, True], ids=["out-of-place", "in-place"])
def test_pass_b_matches_jax(jax_passes, in_place):
    u = tuple(map(_t, jax_passes["a"]))
    out = tuple(x.clone() for x in u) if in_place else None
    got = fu.pass_b(*(out or u), *map(_t, jax_passes["kspec"]), jax_passes["plan"], out=out)
    if in_place:
        assert got[0].data_ptr() == out[0].data_ptr()
    assert _rel(got, jax_passes["b"]) <= PASS_RTOL


def test_pass_b_conj_k_is_the_negated_spectrum(jax_passes):
    """K6's conj_k applies conj(K̂), as JAX's adjoint materialises -im."""
    u = tuple(map(_t, jax_passes["a"]))
    k_re, k_im = map(_t, jax_passes["kspec"])
    plan = jax_passes["plan"]
    got = fu.pass_b(*u, k_re, k_im, plan, conj_k=True)
    want = fu.pass_b(*u, k_re, -k_im, plan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pass_cqa_matches_jax(jax_passes):
    v = tuple(map(_t, jax_passes["b"]))
    got = fu.pass_cqa(*v, _t(jax_passes["view"]), jax_passes["plan"])
    assert _rel(got, jax_passes["cqa"]) <= PASS_RTOL


@pytest.mark.parametrize("lam", [0.0, LAM])
def test_pass_cu_matches_jax(jax_passes, lam):
    v = tuple(map(_t, jax_passes["b"]))
    atol = 4 * float(np.finfo(np.float32).eps) / lam if lam > 0 else 0.0
    psi = _t(jax_passes["psi"])
    got = fu.pass_cu(*v, psi, _t(jax_passes["w"]), jax_passes["plan"], lam, 1e-4)
    assert _rel(got, jax_passes["cu"][lam], atol) <= PASS_RTOL
    # in place, and a scalar weight (K1's plain update underneath)
    p = psi.clone()
    fu.pass_cu(*v, p, 0.25, jax_passes["plan"], lam, 1e-4, out=p)
    integral = fu.pass_c_plain(*v, fu.plan_tensors(jax_passes["plan"], "cpu"))
    want = rl.rl_update(psi, integral, 0.25, lam, 1e-4)
    assert torch.equal(p, want)


def test_dense_spectrum_prep_raises_naming_k5():
    """A kernel z-extent of 9 at Z = 16 needs the dense branch (pass BF, K5).
    It raised until K5 was ported; now the shape alone picks the branch, and
    the dense one forwards through pass A and pass BF
    (tests/test_torch_fused_rest.py holds it against JAX's)."""
    k = torch.from_numpy(gaussian_kernel((9, 5, 5), 1.0))
    got = fu.kernel_spectrum_fused(k, (16, 24, 32))
    want = fu._spectrum_dense(k, (16, 24, 32))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fu.sparse_prep_ok(8, 16) and not fu.sparse_prep_ok(9, 16)


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


def _port(psi0, views, k1, k2, w, **kw):
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    return rl.deconvolve(torch.from_numpy(psi0), data, **kw)


KW = dict(num_iterations=2, lam=LAM, min_value=1e-4)


@pytest.mark.parametrize(
    "adjoint", [False, True], ids=["per-voxel-weights", "adjoint-scalar-weights"]
)
def test_deconvolve_fused_matches_jax_fused_engine(adjoint):
    """The slice: the port's fused driver against deconvolve_jit's fused
    engine (Pallas interpret mode).  Observed: 6.9e-7 and 8.8e-7."""
    args = _inputs(scalar_weights=adjoint)
    psi0 = args[0].copy()
    jdata = JaxData(*(jnp.asarray(a) for a in args[1:]))
    want = np.asarray(
        jrl.deconvolve_jit(jnp.asarray(args[0]), jdata, algorithm="fused",
                           adjoint_kernel2=adjoint, **KW)
    )
    fu.reset_launches()
    got = _port(*args, algorithm="fused", adjoint_kernel2=adjoint, **KW).numpy()
    np.testing.assert_array_equal(args[0], psi0)  # the caller's psi is not written
    assert set(fu.launches.values()) == {0}  # the CPU path runs the plain versions
    assert _rel(got, want) <= SLICE_RTOL


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
def test_fused_prepared_simultaneous_and_history(view_order):
    """The prepared, simultaneous and history paths of the fused driver
    against the port's own sequential fused and fft engines."""
    args = _inputs(scalar_weights=False)
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    psi0 = torch.from_numpy(args[0])
    kw = dict(KW, view_order=view_order)
    fused = rl.deconvolve(psi0, data, algorithm="fused", **kw)
    fft = rl.deconvolve(psi0, data, algorithm="fft", **kw)
    assert _rel(fused.numpy(), fft.numpy()) <= SLICE_RTOL
    prepared = rl.prepare_workspace(data, SHAPE, algorithm="fused")
    assert prepared.algorithm == "fused" and prepared.xmode == "standard"
    got = rl.deconvolve_prepared(psi0, data, prepared, **kw)
    assert _rel(got.numpy(), fused.numpy()) <= SLICE_RTOL
    psi, deltas = rl.deconvolve_with_history(psi0, data, algorithm="fused", **kw)
    _, fft_deltas = rl.deconvolve_with_history(psi0, data, algorithm="fft", **kw)
    assert torch.equal(psi, fused) and deltas.shape == (2,)
    np.testing.assert_allclose(deltas.numpy(), fft_deltas.numpy(), rtol=1e-3)


@pytest.mark.parametrize("adjoint", [False, True], ids=["kernel2", "adjoint"])
def test_prepared_from_jax_fused(adjoint):
    """JAX's fused spectra, carried across as numpy, give the psi of the
    port's own fused prepare."""
    psi0, views, k1, k2, w = _inputs(scalar_weights=adjoint)
    jdata = JaxData(*(jnp.asarray(a) for a in (views, k1, k2, w)))
    jprep = jrl.prepare_workspace(jdata, SHAPE, algorithm="fused", adjoint_kernel2=adjoint)
    carried = prepared_from_jax(
        "fused", SHAPE, tuple(map(np.asarray, jprep.k1)), tuple(map(np.asarray, jprep.k2)),
        xmode=jprep.xmode,
        device="cpu",
    )
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    own = rl.prepare_workspace(data, SHAPE, algorithm="fused", adjoint_kernel2=adjoint)
    assert own.conj_k2 == adjoint and not carried.conj_k2
    got = rl.deconvolve_prepared(torch.from_numpy(psi0), data, carried, **KW).numpy()
    want = rl.deconvolve_prepared(torch.from_numpy(psi0), data, own, **KW).numpy()
    assert _rel(got, want) <= 1e-5


def test_auto_still_means_fft_and_fused_guards():
    """``"auto"`` on the CPU is the JAX package's CPU rule (dft up to 256 per
    axis, fft above, never fused); the fused engine's guards hold."""
    assert rl.resolve_algorithm("auto", (16, 24, 32), "cpu") == "dft"
    assert rl.resolve_algorithm("auto", (512, 512, 512), "cpu") == "fft"
    assert rl.resolve_algorithm("fused", (16, 24, 32), "cpu") == "fused"
    assert rl.fused_eligible((16, 24, 32)) and not rl.fused_eligible((12, 10, 9))
    rng = np.random.default_rng(3)
    views = rng.gamma(2.0, 20.0, (V, 12, 10, 9)).astype(np.float32)
    k = np.stack([gaussian_kernel((3, 3, 3), 1.0)] * V)
    data = multiview_data_from_numpy(views, k, k, np.full((V,), 0.5, np.float32), device="cpu")
    with pytest.raises(ValueError, match="multiples of 8"):
        rl.deconvolve(torch.from_numpy(views[0]), data, 1, algorithm="fused")
    args = _inputs(scalar_weights=True)
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    prepared = rl.prepare_workspace(data, SHAPE, algorithm="fused")
    prepared.xmode = "splitx"
    with pytest.raises(ValueError, match="x-row layout"):
        rl.deconvolve_prepared(torch.from_numpy(args[0]), data, prepared, 1)
    with pytest.raises(ValueError, match="x-row layout"):
        prepared_from_jax("fused", SHAPE, prepared.k1, prepared.k2, xmode="fold", device="cpu")


@pytest.mark.parametrize(
    "zxy, on_card",
    [
        ((512, 512, 512), True),  # bench config 2: R = 4 split stages
        ((256, 256, 384), True),  # y splits 3 ways
        ((256, 256, 640), True),  # 5 ways
        ((256, 256, 896), True),  # 7 ways
        ((256, 256, 1024), True),  # y splits 8 ways
        ((256, 1024, 256), True),
        ((1024, 256, 256), True),  # Z past the old edge of 736: 8 columns of the z stage
        ((736, 832, 256), True),
        ((744, 256, 256), True),
        ((256, 840, 256), True),
        ((16, 1816, 256), True),  # 16 sequences of the FFT x stage fill shared memory
        ((16, 1824, 256), True),  # 8 sequences
        ((8, 8, 3632), True),  # R = 1: 8 rows of the FFT y stage fill shared memory
        ((8, 8, 3640), True),  # 4 rows
        ((256, 2048, 1024), True),  # a 2048-wide frame cropped to 1024 rows, 256 planes
        ((1024, 512, 512), True),  # 1024 planes
        ((8, 3640, 8), True),  # 4 sequences
        ((8, 7272, 8), True),  # 2 sequences
        ((8, 14528, 8), True),  # 2 sequences fill shared memory
        ((8, 8, 7272), True),  # 2 rows
        ((8, 8, 14528), True),
        ((1824, 8, 8), True),  # 8 columns of the z stage
        ((3640, 8, 8), True),  # 4 columns
        ((14528, 8, 8), True),  # 2 columns fill shared memory
        ((8, 8168, 8), True),  # 8·1021: the largest generic radix under 1024
        ((8168, 8, 16), True),
        ((14536, 8, 8), True),  # no tile fits: four-step 92·158 through HBM
        ((8, 14536, 8), True),
        ((8, 8, 14536), True),
        ((8248, 8, 8), True),  # 8·1031, a prime factor over 1024: Bluestein
        ((8, 8248, 8), True),
        ((8, 8, 8248), True),
        ((2**25, 8, 8), True),  # the longest axis served: four-step 4096·8192
        ((8, 33554408, 8), True),  # 8·4194301: Bluestein padded to 2^26
        ((2**25 + 8, 8, 8), False),  # past 2^25
        ((8, 2**25 + 8, 8), False),
        ((8, 8, 2**25 + 8), False),
    ],
    ids=str,
)
def test_fused_limit_holds_the_cuda_kernels_limits(zxy, on_card):
    """fused_limit is the kernels' plan_ok in Python: the CPU path serves
    every shape of multiples of 8; on a CUDA device every axis up to 2^25
    is served (a shared-memory, four-step or Bluestein plan), and a shape
    past it raises NotImplementedError before anything reaches the card,
    naming what the CUDA passes serve and why.  The refusal comes from the
    plan's shape: making a plan builds none of its dense matrices, so a plan
    at the refused shape goes in as it is."""
    Z, X, Y = zxy
    assert fu.fused_limit(zxy) is None and fu.fused_limit(zxy, "cpu") is None
    assert rl.fused_eligible((Z, Y, X)) and fu.check_transposed_shape(zxy) == zxy
    assert (fu.fused_limit(zxy, "cuda") is None) == on_card
    assert rl.fused_eligible((Z, Y, X), torch.device("cuda")) == on_card
    if on_card:
        assert fu.check_transposed_shape(zxy, "cuda") == zxy
        return
    with pytest.raises(NotImplementedError, match="every axis that is a multiple of 8 up to 2\\^25"):
        fu.check_transposed_shape(zxy, "cuda")
    with pytest.raises(NotImplementedError, match="past 2\\^25 = 33554432: a Bluestein transform"):
        fu.plan_tensors(fp.make_fused_plan((Z, Y, X)), "cuda")


def test_plan_builds_dense_matrices_only_for_the_plain_passes():
    """A plan, and its tensors on a device, hold the shape, the splits and
    (on a card) the FFT stage tables; the dense matrices, which only the
    plain passes read, are built and uploaded at a plain pass's first read,
    once."""
    Z, Y, X = shape = (256, 24, 32)
    plan = fp.FusedPlan(shape)
    assert (plan.kxh, plan.kxp, plan.split_z, plan.split_y) == (17, 24, (2, 128), (1, 24))
    c = fu.PlanTensors(plan, torch.device("cpu"))
    lazy = ("_x", "sy", "sz")
    assert not any(name in vars(plan) for name in lazy)
    assert not any(name in vars(c) for name in ("fxp", "bxp", "wfy", "wiy", "wfz", "wiz"))
    xt = torch.rand((Z, X, Y), generator=torch.Generator().manual_seed(0))
    u = fu.pass_a_plain(xt, c)
    assert "_x" in vars(plan) and "sy" in vars(plan) and "sz" not in vars(plan)
    assert c.fxp is c.fxp and c.wfy[0] is c.wfy[0]
    fu.pass_b_plain(*u, *u, c)
    assert all(name in vars(plan) for name in lazy)
    assert np.array_equal(c.wfz[0].numpy(), fd.make_fused_plan(shape).sz.wf[0])


def test_fused_wrappers_never_reach_plain_on_non_cpu(monkeypatch):
    """Only a CPU tensor reaches a plain pass: another device raises."""

    def boom(*a, **k):
        raise AssertionError("plain version reached")

    for name in ("pass_a_plain", "pass_b_plain", "pass_cqa_plain", "pass_cu_plain"):
        monkeypatch.setattr(fu, name, boom)
    fu.reset_launches()
    plan = fp.make_fused_plan((8, 8, 8))
    m = torch.empty((8, 8, 8), device="meta")
    s = torch.empty((plan.kxp, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_a(m, plan)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_b(s, s, s, s, plan)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_cqa(s, s, m, plan)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.pass_cu(s, s, m, 0.5, plan, 0.0, 1e-4)
    c = torch.zeros((plan.kxp, 8, 8))
    with pytest.raises(ValueError, match="shape"):
        fu.pass_b(c, c, c[:, :4].contiguous(), c, plan)
    with pytest.raises(ValueError, match="negative view"):
        fu.pass_b(c, c, c, c._neg_view(), plan, conj_k=True)
    assert set(fu.launches.values()) == {0}
