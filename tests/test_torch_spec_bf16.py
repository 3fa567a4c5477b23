"""bf16 storage of the fused spectra (``LMVN_FUSED_SPEC_BF16=1``): the port's
fused engine against the JAX package's under the same knob, run in interpret
mode at ``precision="highest"`` as tests/test_pallas_ops.py runs it; and the
dense kernel-spectrum forwarding against JAX's (``LMVN_FUSED_SPARSE_PREP=0``
there; the port picks the branch from the shape and reaches the dense one
directly here).

On the CPU every pass wrapper runs its plain PyTorch version: the spectra it
reads are widened to float32, the spectrum it writes is rounded once to bf16
(nearest even), where JAX's ``_ld`` and ``astype`` do.  The bf16 CUDA
instantiations are held against the same plain versions on the card by
chip_smoke.py (phase 28); here a stand-in for the kernel library shows which
entry each wrapper launches and that the scratch pair between a pass's
stages is float32 in every launch.

bf16 data crosses between the frameworks exactly: ml_dtypes' bfloat16 to
float32 to ``torch.bfloat16``.

Tolerances:
* a bf16 output may differ from JAX's by one bf16 step where the two f32
  values, computed in another order (measured within 1.5e-6 of max|ref| in
  tests/test_torch_fused.py), round apart:
  |a - b| <= 2^-7 · max(|a|, |b|) + 2e-6 · max|b| elementwise;
* an f32 output (K7, K9, K10's psi'): 1e-5 of max|ref| (with K1's Tikhonov
  slack, 4 ulp(1)/λ, at λ > 0), as for the f32 passes;
* one RL view step in bf16: 2e-2 max-relative of the f32 step and of the
  fft view step, JAX's own envelope (tests/test_pallas_ops.py:538-573), and
  1e-3 of max|psi| of JAX's bf16 step; measured 2.1e-3, 2.1e-3 and 4.7e-7;
* a whole fused deconvolve under the knob, 2 views and 2 iterations: 1e-3
  of max|psi| of JAX's (inside JAX's 2e-2); measured 6.3e-5;
* spectra prepared under one setting and run under the other: 1e-3 of
  max|psi| of JAX doing the same; measured 1.3e-5 (f32 spectra, bf16 chain)
  and 9.5e-7 (bf16 spectra, f32 chain);
* 1e-3 of JAX's result tells bf16 storage from f32: the port with the
  storage of the other setting is held to fail it (the f32 step reads
  2.1e-3 and the f32 chain 3.4e-3 from JAX's bf16 ones; the mixed runs'
  unmixed chains 4.1e-3 from JAX's mixed ones);
* the carried chain bitwise the plain one, as at f32;
* the dense forwarding: 1e-5 of max|ref| against JAX's and against the
  z-sparse one, as JAX holds the two.
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
from libmultiviewnative_torch.interop import multiview_data_from_numpy, prepared_from_jax
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp
from libmultiviewnative_torch.parallel.sharded import deconvolve_sharded, make_mesh
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

BF16 = torch.bfloat16
PASS_RTOL = 1e-5
STEP_RTOL = 2e-2
BF16_RTOL = 1e-3
LAM = 0.006
MIN_VALUE = 1e-4
TIKHONOV_ATOL = 4 * float(np.finfo(np.float32).eps) / LAM
RUN = dict(interpret=True, precision="highest")
# (Z, Y, X): dense stages; a lane-misaligned y ((R·M) % 128 != 0, M >= 128)
SHAPES = [(16, 24, 32), (16, 136, 16)]
STEP_SHAPE = (16, 128, 16)  # tests/test_pallas_ops.py's bf16 step
V = 2
KW = dict(num_iterations=2, lam=LAM, min_value=MIN_VALUE)


def _t(a):
    """A JAX output as a torch tensor of the same dtype, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(BF16)
    return torch.from_numpy(a.copy())


def _dtype(a):
    """The torch dtype of a JAX output (or of its torch copy)."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    return BF16 if np.asarray(a).dtype.name == "bfloat16" else torch.float32


def _flat(x):
    parts = x if isinstance(x, (tuple, list)) else (x,)
    return np.concatenate([
        (p.float().numpy() if isinstance(p, torch.Tensor) else np.asarray(p, np.float32)).ravel()
        for p in parts
    ]).astype(np.float64)


def _steps(got, want) -> float:
    """The largest |a - b| over its one-bf16-step allowance 2^-7·max(|a|,
    |b|) + 2e-6·max|b|, elementwise over an output or an (re, im) pair: at
    most 1 where the two differ by at most one rounding."""
    a, b = _flat(got), _flat(want)
    assert a.shape == b.shape and np.isfinite(a).all()
    lim = 2.0**-7 * np.maximum(np.abs(a), np.abs(b)) + 2e-6 * np.abs(b).max()
    return float(np.max(np.abs(a - b) / lim))


def _rel(got, want, atol=0.0) -> float:
    """max(|got - want| - atol) over max|want|."""
    a, b = _flat(got), _flat(want)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.max(np.maximum(np.abs(a - b) - atol, 0.0)) / np.abs(b).max())


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def jax_bf16(request):
    """Inputs and the JAX package's interpret-mode outputs of every pass
    under ``LMVN_FUSED_SPEC_BF16=1`` at one shape, each pass fed JAX's own
    bf16 spectra."""
    shape = request.param
    Z, Y, X = shape
    rng = np.random.default_rng(13)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    view = rng.uniform(1.0, 200.0, (Z, X, Y)).astype(np.float32)
    w = rng.uniform(0.0, 0.5, (Z, X, Y)).astype(np.float32)
    k = gaussian_kernel((5, 5, 5), 1.2)
    kt = np.ascontiguousarray(wrap_kernel(torch.from_numpy(k), shape).numpy().transpose(0, 2, 1))
    plan = fd.make_fused_plan(shape)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LMVN_FUSED_SPEC_BF16", "1")
        ks = fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest")
        uk = fd._run_pass_a(jnp.asarray(kt), plan, 8, **RUN)
        a = fd._run_pass_a(jnp.asarray(psi), plan, 8, **RUN)
        b = fd._run_pass_b(*a, *ks, plan, **RUN)
        out = dict(
            pass_a=a, pass_bf=fd._run_pass_bf(*uk, plan, **RUN), pass_b=b,
            pass_c=fd._run_pass_c(*b, plan, 8, **RUN),
            pass_cqa=fd._run_pass_cqa(*b, jnp.asarray(view), plan, 8, **RUN),
            pass_cu=fd._run_pass_cu(*b, jnp.asarray(psi), jnp.asarray(w), plan, 8, LAM,
                                    MIN_VALUE, **RUN),
            pass_cua=fd._run_pass_cua(*b, jnp.asarray(psi), jnp.asarray(w), plan, 8, LAM,
                                      MIN_VALUE, **RUN),
        )
    tensors = lambda x: tuple(map(_t, x)) if isinstance(x, tuple) else _t(x)
    return dict(
        shape=shape, psi=torch.from_numpy(psi), view=torch.from_numpy(view),
        w=torch.from_numpy(w), ks=tensors(ks), uk=tensors(uk),
        out={name: tensors(x) for name, x in out.items()},
        plan=fp.make_fused_plan(shape),
    )


def _port_pass(name, j):
    """(port output, plain float32 output of the same inputs, rounded where
    the pass stores a spectrum) of pass ``name`` on ``j``'s inputs, bf16
    storage."""
    plan, c = j["plan"], fu.plan_tensors(j["plan"], "cpu")
    psi, view, w = j["psi"], j["view"], j["w"]
    a, b = j["out"]["pass_a"], j["out"]["pass_b"]
    wide = lambda pair: tuple(x.float() for x in pair)
    rounded = lambda pair: tuple(x.to(BF16) for x in pair)
    if name == "pass_a":
        return fu.pass_a(psi, plan), rounded(fu.pass_a_plain(psi, c))
    if name == "pass_bf":
        return fu.pass_bf(*j["uk"], plan), rounded(fu.pass_bf_plain(*wide(j["uk"]), c))
    if name == "pass_b":
        return (fu.pass_b(*a, *j["ks"], plan),
                rounded(fu.pass_b_plain(*wide(a), *wide(j["ks"]), c)))
    if name == "pass_c":
        return fu.pass_c(*b, plan), fu.pass_c_plain(*wide(b), c)
    if name == "pass_cqa":
        return fu.pass_cqa(*b, view, plan), rounded(fu.pass_cqa_plain(*wide(b), view, c))
    if name == "pass_cu":
        return (fu.pass_cu(*b, psi, w, plan, LAM, MIN_VALUE),
                fu.pass_cu_plain(*wide(b), psi, w, c, LAM, MIN_VALUE))
    new, u = fu.pass_cua(*b, psi, w, plan, LAM, MIN_VALUE)
    new32, u32 = fu.pass_cua_plain(*wide(b), psi, w, c, LAM, MIN_VALUE)
    return (new, *u), (new32, *rounded(u32))


@pytest.mark.parametrize("name", fu.PASSES)
def test_pass_bf16_matches_jax(jax_bf16, name, monkeypatch):
    """Each pass in bf16 storage against JAX's under the knob: the dtypes
    JAX gives, a bf16 output within one bf16 step, an f32 one within 1e-5;
    and the plain pass is the f32 pass on the widened inputs, rounded once
    (bitwise)."""
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    got, once = _port_pass(name, jax_bf16)
    want = jax_bf16["out"][name]
    got, once, want = (x if isinstance(x, tuple) else (x,) for x in (got, once, want))
    assert [g.dtype for g in got] == [_dtype(w) for w in want]
    assert all(torch.equal(g, o) for g, o in zip(got, once))
    if name in ("pass_c", "pass_cu", "pass_cua"):  # the f32 volume comes first
        atol = TIKHONOV_ATOL if name != "pass_c" else 0.0
        assert _rel(got[0], want[0], atol) <= PASS_RTOL
        got, want = got[1:], want[1:]
    if got:
        assert all(g.dtype == BF16 for g in got)
        assert _steps(got, want) <= 1.0
        kx = jax_bf16["plan"].kxh
        assert all(not g[kx:].any() for g in got)  # pad rows


@pytest.mark.parametrize("sparse", ["1", "0"], ids=["z-sparse", "dense"])
def test_kernel_spectrum_bf16_matches_jax(sparse, monkeypatch):
    """The forwarded kernel spectrum under the knob, on both branches: pass
    A's spectrum stored in bf16 and widened for the z contraction (sparse,
    the branch the shape picks) or for pass BF (dense), the result stored in
    bf16, as JAX does (its dense branch by ``LMVN_FUSED_SPARSE_PREP=0``)."""
    shape, k = (16, 24, 32), gaussian_kernel((5, 5, 5), 1.2)
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    monkeypatch.setenv("LMVN_FUSED_SPARSE_PREP", sparse)
    assert fu.sparse_prep_ok(5, shape[0])
    want = fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest")
    forward = fu.kernel_spectrum_fused if sparse == "1" else fu._spectrum_dense
    got = forward(torch.from_numpy(k), shape)
    assert [g.dtype for g in got] == [_dtype(w) for w in want] == [BF16, BF16]
    assert all(g.is_contiguous() for g in got)
    assert _steps(got, want) <= 1.0


def _step_inputs():
    """tests/test_pallas_ops.py's bf16 step fixture at STEP_SHAPE, transposed."""
    Z, Y, X = STEP_SHAPE
    rng = np.random.default_rng(7)
    view_t = rng.gamma(2.0, 10.0, (Z, X, Y)).astype(np.float32)
    psi_t = np.full((Z, X, Y), 20.0, np.float32)
    k1 = gaussian_kernel((5, 5, 5), 1.0)
    return psi_t, view_t, k1, np.flip(k1).copy()


def test_rl_view_step_bf16(monkeypatch):
    """One RL view step with bf16 spectra within JAX's envelope of the f32
    step and of the fft view step, and within 1e-3 of JAX's bf16 step,
    which the f32 step is not."""
    psi_t, view_t, k1, k2 = _step_inputs()
    psi, view = torch.from_numpy(psi_t), torch.from_numpy(view_t)
    kt1, kt2 = torch.from_numpy(k1), torch.from_numpy(k2)
    steps = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", knob)
        s1, s2 = (fu.kernel_spectrum_fused(k, STEP_SHAPE) for k in (kt1, kt2))
        assert s1[0].dtype == (BF16 if knob == "1" else torch.float32)
        steps[knob] = rl.rl_view_step_fused(psi, view, s1, s2, 0.5, LAM, MIN_VALUE)
    jaxs = [fd.kernel_spectrum_fused(jnp.asarray(k), STEP_SHAPE) for k in (k1, k2)]  # bf16
    want_jax = np.asarray(fd.fused_rl_step_transposed(
        jnp.asarray(psi_t), jnp.asarray(view_t), np.float32(0.5), *jaxs, LAM, MIN_VALUE,
        interpret=True))
    k1h, k2h = (rl.prepare_spectra(k[None], STEP_SHAPE)[0] for k in (kt1, kt2))
    natural = lambda t: t.transpose(1, 2).contiguous()
    fft = natural(rl.rl_view_step(natural(psi), natural(view), k1h, k2h, 0.5, LAM, MIN_VALUE))
    assert steps["1"].dtype == torch.float32
    assert _rel(steps["1"], steps["0"]) < STEP_RTOL
    assert _rel(steps["1"], fft) < STEP_RTOL
    assert _rel(steps["1"], want_jax) < BF16_RTOL < _rel(steps["0"], want_jax)


def _inputs(scalar_weights=False, seed=0, views=V):
    rng = np.random.default_rng(seed)
    V = views
    views = rng.gamma(2.0, 20.0, (V,) + STEP_SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(V)])
    k2 = np.stack([np.flip(k).copy() for k in k1])
    if scalar_weights:
        w = np.full((V,), 1.0 / V, np.float32)
    else:
        w = rng.uniform(0.5, 1.5, (V,) + STEP_SHAPE).astype(np.float32)
        w /= w.sum(axis=0, keepdims=True)
    return np.full(STEP_SHAPE, views.mean(), np.float32), views, k1, k2, w


def _jax_data(args):
    return JaxData(*(jnp.asarray(a) for a in args[1:]))


def test_deconvolve_fused_bf16_matches_jax(monkeypatch):
    """The slice under the knob: the port's fused ``deconvolve`` against
    deconvolve_jit's fused engine, both storing their spectra in bf16,
    within 1e-3 of max|psi|, which the port's f32 chain is not."""
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    args = _inputs()
    want = np.asarray(jrl.deconvolve_jit(jnp.asarray(args[0]), _jax_data(args),
                                         algorithm="fused", **KW))
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    fu.reset_launches()
    got = rl.deconvolve(torch.from_numpy(args[0]), data, algorithm="fused", **KW)
    assert set(fu.launches.values()) == {0}  # the CPU path runs the plain versions
    assert got.dtype == torch.float32
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "0")
    f32 = rl.deconvolve(torch.from_numpy(args[0]), data, algorithm="fused", **KW)
    assert _rel(got, want) < BF16_RTOL < _rel(f32, want)


def test_carried_chain_bf16_is_the_plain_chain(monkeypatch):
    """``LMVN_FUSED_CARRY=1`` under the knob: K10 stores the next step's
    spectrum in bf16 where the plain chain's K4 does, from the same psi', so
    on the CPU the two chains agree bit for bit, as at f32."""
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    args = _inputs(seed=4)
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    out = {}
    for carry in ("0", "1"):
        monkeypatch.setenv("LMVN_FUSED_CARRY", carry)
        out[carry] = rl.deconvolve(torch.from_numpy(args[0]), data, algorithm="fused", **KW)
    assert torch.equal(out["0"], out["1"])


@pytest.mark.parametrize("prep,run", [("0", "1"), ("1", "0")], ids=["f32-spectra-bf16-chain",
                                                                     "bf16-spectra-f32-chain"])
def test_mixed_storage_matches_jax(prep, run, monkeypatch):
    """Spectra prepared under one setting of the knob and run under the
    other, on both sides, within 1e-3 of max|psi|, which the port with the
    prepared setting in the chain too is not; JAX's prepared spectra carried
    across keep their dtype and give the port's own."""
    args = _inputs(scalar_weights=True, seed=1, views=1)
    jdata, data = _jax_data(args), multiview_data_from_numpy(*args[1:], device="cpu")
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", prep)
    jprep = jrl.prepare_workspace(jdata, STEP_SHAPE, algorithm="fused")
    own = rl.prepare_workspace(data, STEP_SHAPE, algorithm="fused")
    carried = prepared_from_jax("fused", STEP_SHAPE, tuple(map(np.asarray, jprep.k1)),
                                tuple(map(np.asarray, jprep.k2)), xmode=jprep.xmode,
                                device="cpu")
    dtype = BF16 if prep == "1" else torch.float32
    assert [x.dtype for x in (*own.k1, *carried.k1)] == [dtype] * 4
    assert _steps(carried.k1, own.k1) <= 1.0 and _steps(carried.k2, own.k2) <= 1.0
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", run)
    want = np.asarray(jrl.deconvolve_prepared(jnp.asarray(args[0]), jdata, jprep, **KW))
    psi0 = torch.from_numpy(args[0])
    for prepared in (own, carried):
        got = rl.deconvolve_prepared(psi0, data, prepared, **KW)
        assert _rel(got, want) < BF16_RTOL
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", prep)
    unmixed = rl.deconvolve_prepared(psi0, data, own, **KW)
    assert _rel(unmixed, want) > BF16_RTOL


@pytest.mark.parametrize(
    "shape,kshape",
    [((64, 256, 16), (5, 5, 5)), ((256, 16, 16), (21, 9, 9)), ((64, 16, 16), (8, 6, 6))],
    ids=str,
)
def test_dense_forwarding_matches_jax_and_sparse(shape, kshape, monkeypatch):
    """Where the z-sparse branch applies, the dense forwarding (pass A and
    pass BF) gives JAX's dense forwarding (``LMVN_FUSED_SPARSE_PREP=0``)
    within 1e-5, and the port's sparse one within 1e-5
    (tests/test_pallas_ops.py:428-450)."""
    k = np.random.default_rng(3).standard_normal(kshape).astype(np.float32)
    assert fu.sparse_prep_ok(kshape[0], shape[0])
    sparse = fu.kernel_spectrum_fused(torch.from_numpy(k), shape)
    monkeypatch.setenv("LMVN_FUSED_SPARSE_PREP", "0")
    want = fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest")
    got = fu._spectrum_dense(torch.from_numpy(k), shape)
    assert _rel(got, want) <= PASS_RTOL
    assert _rel(got, sparse) <= PASS_RTOL


def test_mesh_1x1_bf16_matches_in_core(monkeypatch):
    """A 1×1 mesh of the CPU under the knob runs the fused step of
    in-core's sequential order on the whole volume: bitwise in-core's."""
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    args = _inputs(scalar_weights=True, seed=2)
    data = multiview_data_from_numpy(*args[1:], device="cpu")
    psi0 = torch.from_numpy(args[0])
    mesh = make_mesh(1, 1, devices=["cpu"])
    kw = dict(lam=LAM, min_value=MIN_VALUE, algorithm="fused", view_order="sequential")
    got = deconvolve_sharded(psi0, data, 2, mesh, **kw)
    want = rl.deconvolve(psi0, data, 2, **kw)
    assert torch.equal(got, want)
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "0")
    assert not torch.equal(rl.deconvolve(psi0, data, 2, **kw), want)  # the knob was read


@pytest.mark.parametrize("value,dtype", [(None, torch.float32), ("0", torch.float32),
                                         ("1", BF16), ("true", torch.float32)])
def test_knob_read_at_each_call(value, dtype, monkeypatch):
    """``spec_dtype`` follows JAX's reading of the knob (only ``"1"`` turns
    bf16 on), read at each call; a pass stores what it reads then."""
    if value is None:
        monkeypatch.delenv("LMVN_FUSED_SPEC_BF16", raising=False)
    else:
        monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", value)
    assert fu.spec_dtype() == dtype
    plan = fp.make_fused_plan(DISPATCH_SHAPE)
    Z, Y, X = DISPATCH_SHAPE
    assert [t.dtype for t in fu.pass_a(torch.ones((Z, X, Y)), plan)] == [dtype] * 2


# ---------------------------------------------------------------- CUDA dispatch
# The CUDA branch of each wrapper on CPU tensors, with the kernel library
# replaced by a recorder: which entry launches for each mix of dtypes, what
# is widened, that the scratch pair t is float32, and where the result is
# rounded.  Nothing is computed, so only dtypes, pointers and counts are held.

class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    lib, made = _Recorder(), {"scratch": [], "out": []}
    monkeypatch.setattr(fu._build, "library", lambda: lib)
    monkeypatch.setattr(fu, "_stream", lambda dev: None)
    monkeypatch.setattr(fu, "_device", lambda *ts: torch.device("cuda", 0))

    def plan_tensors(plan, dev):
        c = fu.PlanTensors(plan, torch.device("cpu"))
        c.args = fu._PlanArgs()
        return c

    def spy(key, fn):
        def wrapped(*a):
            res = fn(*a)
            made[key].extend(res)
            return res
        return wrapped

    monkeypatch.setattr(fu, "plan_tensors", plan_tensors)
    monkeypatch.setattr(fu, "_scratch", spy("scratch", fu._scratch))
    monkeypatch.setattr(fu, "_outputs", spy("out", fu._outputs))
    fu.reset_launches()
    yield lib, made
    fu.reset_launches()


DISPATCH_SHAPE = (16, 24, 32)
F32 = torch.float32
# (storage, dtype of the spectra read, the entry that launches)
MIXES = [(F32, F32, ""), (BF16, BF16, "_bf16"), (BF16, F32, ""), (F32, BF16, "")]


def _pair(dtype, plan):
    return tuple(torch.zeros(fu._spec_shape(plan), dtype=dtype) for _ in "ri")


@pytest.mark.parametrize("name", fu.PASSES)
@pytest.mark.parametrize("spec,reads,suffix", MIXES,
                         ids=["f32", "bf16", "f32-read-bf16-store", "bf16-read-f32-store"])
def test_cuda_dispatch(card, name, spec, reads, suffix, monkeypatch):
    lib, made = card
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1" if spec == BF16 else "0")
    plan = fp.make_fused_plan(DISPATCH_SHAPE)
    Z, Y, X = DISPATCH_SHAPE
    vol = torch.ones((Z, X, Y))
    s_in = _pair(reads, plan)
    writes = name not in ("pass_c", "pass_cu")
    if not writes:
        suffix = "_bf16" if reads == BF16 else ""
    if name == "pass_a":
        suffix = "_bf16" if spec == BF16 else ""
    call = {
        "pass_a": lambda: fu.pass_a(vol, plan),
        "pass_bf": lambda: fu.pass_bf(*s_in, plan),
        "pass_b": lambda: fu.pass_b(*s_in, *_pair(spec, plan), plan),
        "pass_c": lambda: fu.pass_c(*s_in, plan),
        "pass_cqa": lambda: fu.pass_cqa(*s_in, vol, plan),
        "pass_cu": lambda: fu.pass_cu(*s_in, vol, 0.5, plan, LAM, MIN_VALUE),
        "pass_cua": lambda: fu.pass_cua(*s_in, vol, 0.5, plan, LAM, MIN_VALUE)[1],
    }[name]
    res = call()
    (entry, args), = lib.calls
    assert entry == f"lmvn_fused_{name}{suffix}"
    assert fu.launches[name + suffix] == 1 and sum(fu.launches.values()) == 1
    kind = BF16 if suffix else F32
    ptrs = set(args)
    # the scratch pair: float32 in every launch, handed to the kernel
    if name not in ("pass_b", "pass_bf"):
        assert len(made["scratch"]) == 2
        assert all(t.dtype == F32 and t.data_ptr() in ptrs for t in made["scratch"])
    # a spectrum read in another dtype than the launch's is widened first
    if name != "pass_a":
        assert all((t.data_ptr() in ptrs) == (t.dtype == kind) for t in s_in)
    if writes:
        scratch = {t.data_ptr() for t in made["scratch"]}
        outs = [t for t in made["out"] if t.data_ptr() in ptrs - scratch]
        assert len(outs) == 2 and all(t.dtype == kind for t in outs)
        assert [r.dtype for r in res] == [spec, spec]
        # rounded after the launch only where a float32 launch stores bf16
        assert all((r.data_ptr() == o.data_ptr()) == (kind == spec) for r, o in zip(res, outs))


def test_cuda_dispatch_in_place(card, monkeypatch):
    """In-place pass B and K10's u over v keep the caller's buffers, in bf16
    storage as in f32, also when a float32 kernel spectrum makes the launch
    f32 (then the result is rounded into them)."""
    lib, made = card
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    plan = fp.make_fused_plan(DISPATCH_SHAPE)
    for k_dtype, entry in ((BF16, "lmvn_fused_pass_b_bf16"), (F32, "lmvn_fused_pass_b")):
        u = _pair(BF16, plan)
        got = fu.pass_b(*u, *_pair(k_dtype, plan), plan, out=u)
        assert got is u and lib.calls[-1][0] == entry
    with pytest.raises(TypeError, match="bfloat16"):
        fu.pass_b(*_pair(F32, plan), *_pair(F32, plan), plan, out=_pair(F32, plan))
    Z, Y, X = DISPATCH_SHAPE
    v = _pair(BF16, plan)
    psi, u = fu.pass_cua(*v, torch.ones((Z, X, Y)), 0.5, plan, LAM, MIN_VALUE, u_out=v)
    assert u is v and lib.calls[-1][0] == "lmvn_fused_pass_cua_bf16"
