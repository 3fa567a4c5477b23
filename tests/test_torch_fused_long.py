"""The fused passes at the long axes: the four-step and Bluestein transforms
that K4-K10 run through HBM where no shared-memory FFT stage holds a length
(ops/csrc/fft_long.cuh, fft_long.cu), emulated in numpy as the kernels run
them.

On the card a long axis runs as a gather into a work buffer, the transform
in place on it, the pass's pointwise step between two transforms, and a
scatter (fft_long.cu).  These tests hold what those launches compute:

* the emulated transforms (``_long_fft``: the four-step's two column-FFT
  steps on the direct stages of ``make_fft_stages``, its float64 twiddles
  rounded to float32; Bluestein's chirp, padded transform, product with
  ``bhat`` and inverse) reproduce ``np.fft.fft`` and its unscaled inverse to
  1e-6 of max|·| at small lengths forced to the four-step and Bluestein
  kinds (``make_fft_stages``' private ``direct_max`` and ``radix_max``) and
  at the long lengths phase 30 of chip_smoke.py runs (14536, 16384, 17280,
  8248, 116152), each frequency read where ``spectrum_at`` puts it;
* with one axis forced long, the emulated K4, K7, K8, K9 and K10 (x or y
  long) and K5 and K6 (z long) reproduce the plain passes to 1e-5 of
  max|·| over the (re, im) pair, psi' at λ 0.006 to rtol 2e-4, atol 5e-5
  as tests/test_torch_fft_stages.py holds it;
* at one small shape per axis they reproduce the JAX package's pass in
  Pallas interpret mode (K8 with x long, K10 with y long, K6 with z long).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp
from test_torch_fft_stages import (
    FFT_RTOL, PAIR_RTOL, _assert_psi, _c64, _cqa_inputs, _emulate_y_stage, _emulate_z_stage,
    _load_half_spectra, _pair_columns, _pair_rel, _rl_inputs, _rl_one, _run_stages,
    _run_stages_dif, _store_half_spectra, _unpair_columns,
)

torch.set_num_threads(1)

# (n, direct_max, radix_max): the four-step kind at small lengths (40 = 5·8,
# 64 = 8·8, 88 = 8·11, 200 = 10·20, 264 = 12·22), Bluestein at 88 = 8·11
# and 264 = 8·3·11 with a generic radix refused (padded to 256 = 16·16 and
# 1024 = 32·32, four-step), and at 104 = 8·13 padded to a direct 256
FORCED = [(40, 8, 1024), (64, 8, 1024), (88, 11, 1024), (200, 20, 1024), (264, 24, 1024),
          (88, 16, 8), (264, 32, 8), (104, 256, 8)]
# the long lengths of chip_smoke.py's phase 30, with their real plans
LONG = [14536, 16384, 17280, 8248, 116152]
DEFAULT = (fp.DIRECT_MAX, fp.MAX_RADIX)


def _direct(st, seqs, inverse):
    """col_fft_kernel on (n, S) sequences: the digit-reversed load, then
    run_stages; natural order out."""
    buf = np.empty(seqs.shape, np.complex64)
    buf[st.pos] = seqs
    return _run_stages(st, buf, inverse)


def _twiddle(r, n, inverse):
    """W_n^r (conjugated for the inverse), float64 rounded to float32."""
    return np.exp((2j if inverse else -2j) * np.pi * (r % n) / n).astype(np.complex64)


def _four_step(st, w, inverse):
    a, b = st.parts
    n1, n2, S = a.n, b.n, w.shape[1]
    tw = _twiddle(np.arange(n1)[:, None, None] * np.arange(n2)[None, :, None], st.n, inverse)
    v = w[: st.n].reshape(n1, n2, S)  # position N2·j1 + j2 (forward) or N2·k1 + k2 (inverse)
    if not inverse:
        # N1-point transforms over j1, times W_n^{j2 k1}; N2-point over j2
        y = (_direct(a, v.reshape(n1, n2 * S), False).reshape(n1, n2, S) * tw).astype(np.complex64)
        z = _direct(b, y.transpose(1, 0, 2).reshape(n2, n1 * S), False)
        return z.reshape(n2, n1, S).transpose(1, 0, 2).reshape(st.n, S)
    y = _direct(b, v.transpose(1, 0, 2).reshape(n2, n1 * S), True)
    y = (y.reshape(n2, n1, S).transpose(1, 0, 2) * tw).astype(np.complex64)
    return _direct(a, y.reshape(n1, n2 * S), True).reshape(st.n, S)


def _bluestein(st, w, inverse):
    n, m = st.n, st.m
    inner = st.parts[0]
    b = st.chirp[:, None] if inverse else np.conj(st.chirp)[:, None]
    x = np.zeros((m, w.shape[1]), np.complex64)
    x[:n] = w[:n] * b
    f = _long_fft(inner, x, False)
    k = np.arange(m)
    bhat = np.conj(st.bhat[(m - k) % m]) if inverse else st.bhat
    at = fp.spectrum_at(inner, k)
    f[at] = (f[at] * bhat[:, None]).astype(np.complex64)
    y = _long_fft(inner, f, True)
    y[:n] = y[:n] * b
    return y


def _long_fft(st, w, inverse):
    """long_fft of fft_long.cu on (npad, S) complex64 sequences: forward,
    natural order in, frequency k at spectrum_at(k) out; inverse
    (unscaled), from that order to natural."""
    if st.kind == "direct":
        return _direct(st, w, inverse)
    return (_four_step if st.kind == "four_step" else _bluestein)(st, w, inverse)


def _stages(shape, axis, force):
    """x, y, z stage plans of a (Z, Y, X) shape, ``axis`` made with
    (direct_max, radix_max) ``force``."""
    Z, Y, X = shape
    return {a: fp.make_fft_stages(n, *(force if a == axis else DEFAULT))
            for a, n in (("x", X), ("y", Y), ("z", Z))}


def _spectrum(st, seqs):
    """The forward transform's frequencies in natural order: (n, S)."""
    return _long_fft(st, seqs.astype(np.complex64), False)[fp.spectrum_at(st, np.arange(st.n))]


def _inverse(st, spec):
    """The unscaled inverse of natural-order frequencies, placed where the
    transform takes them: (n, S)."""
    w = np.zeros((st.m if st.kind == "bluestein" else st.n, spec.shape[1]), np.complex64)
    w[fp.spectrum_at(st, np.arange(st.n))] = spec
    return _long_fft(st, w, True)[: st.n]


@pytest.mark.parametrize("n, direct_max, radix_max", FORCED + [(n,) + DEFAULT for n in LONG],
                         ids=lambda v: str(v))
def test_long_transforms_reproduce_numpy_fft(n, direct_max, radix_max):
    st = fp.make_fft_stages(n, direct_max, radix_max)
    assert st.kind != "direct"
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    want = np.fft.fft(x, axis=0)
    got = _spectrum(st, x)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= FFT_RTOL
    got = _inverse(st, x.astype(np.complex64))
    want = np.fft.ifft(x, axis=0) * n
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= FFT_RTOL


def test_plan_kinds_at_the_long_lengths():
    """The kinds and sizes phase 30 runs: four-step splits nearest √n into
    two direct lengths, Bluestein padded to the power of two at least 2n − 1,
    whose own plan is four-step; the direct plans below are untouched."""
    kinds = {n: fp.plan_kind(n) for n in LONG + [14528, 8168, 2**25]}
    assert kinds == {
        14536: ("four_step", (92, 158)), 16384: ("four_step", (128, 128)),
        17280: ("four_step", (128, 135)), 8248: ("bluestein", (32768,)),
        116152: ("bluestein", (262144,)), 14528: ("direct", ()), 8168: ("direct", ()),
        2**25: ("four_step", (4096, 8192)),
    }
    st = fp.make_fft_stages(8248)
    assert st.parts[0].kind == "four_step" and [p.n for p in st.parts[0].parts] == [128, 256]
    assert st.chirp.dtype == st.bhat.dtype == np.complex64 and st.bhat.shape == (32768,)
    # the longest Bluestein length served, 8·4194301, pads to 2^26 = 8192²
    assert fp.plan_kind(33554408) == ("bluestein", (2**26,))
    assert fp.plan_kind(2**26) == ("four_step", (8192, 8192))


# ---------------------------------------------------------------- passes


def _x_forward(st, xt):
    """K4's x stage: (Z, X, Y) real -> (Kx, Z, Y) half spectra."""
    Z, X, Y = xt.shape
    seq = 16 if st.kind == "direct" else Y // 2  # a block's tile, or every column pair
    pairs = _pair_columns(xt.transpose(1, 0, 2), seq)
    if st.kind == "direct":
        buf = np.empty_like(pairs)
        buf[st.pos] = pairs
        return _store_half_spectra(_run_stages(st, buf, False), np.arange(X), Z, Y, seq)
    F = _long_fft(st, pairs, False)[:X]
    return _store_half_spectra(F, fp.spectrum_at(st, np.arange(X)), Z, Y, seq)


def _gather_half(st, t, seq):
    """x_gather_half: load_half_spectra's rule with Z_k at spectrum_at(k)."""
    X = st.n
    kx = t.shape[0]
    at = fp.spectrum_at(st, np.arange(X))
    fake = fp.FftStages(X, (), st.tw, at, "direct")
    buf = _load_half_spectra(fake, t, seq)
    if st.kind == "bluestein":
        buf = np.concatenate([buf, np.zeros((st.m - X, buf.shape[1]), np.complex64)])
    return buf


def _x_inverse(st, t):
    """K7-K10's x stage up to the op: (X, Z, Y) values times 1/X."""
    X = st.n
    _, Z, Y = t.shape
    seq = 16 if st.kind == "direct" else Y // 2
    if st.kind == "direct":
        buf = _run_stages(st, _load_half_spectra(st, t, seq), True)
    else:
        buf = _long_fft(st, _gather_half(st, t, seq), True)[:X]
    return _unpair_columns(buf, Z, Y, seq) * np.float32(1.0 / X)


def _x_forward_half(st, vol):
    """The forward half of K8's and K10's x stage on (X, Z, Y) values:
    (Kx, Z, Y) half spectra."""
    X, Z, Y = vol.shape
    seq = 16 if st.kind == "direct" else Y // 2
    if st.kind == "direct":
        return _store_half_spectra(_run_stages_dif(st, _pair_columns(vol, seq)), st.pos, Z, Y, seq)
    F = _long_fft(st, _pair_columns(vol, seq), False)[:X]
    return _store_half_spectra(F, fp.spectrum_at(st, np.arange(X)), Z, Y, seq)


def _y(st, split, rows, inverse):
    """The y stage on (g, Y) complex rows: forward natural -> split order,
    inverse split order -> natural times 1/Y."""
    if st.kind == "direct":
        return _emulate_y_stage(st, rows, split, inverse)
    Y = st.n
    at = fp.spectrum_at(st, fp.split_perm(Y, split))  # where frequency split_freq(j) sits
    if not inverse:
        return _long_fft(st, rows.T.astype(np.complex64), False)[at].T
    w = np.zeros((st.m if st.kind == "bluestein" else Y, rows.shape[0]), np.complex64)
    w[at] = rows.T
    return (_long_fft(st, w, True)[:Y] * np.float32(1.0 / Y)).T


def _pair_out(plan, t_spec, stages):
    """K4's y stage on (Kx, Z, Y) half spectra: the (re, im) pair, pad rows
    zero."""
    Z, Y, _ = plan.shape
    kx = plan.kxh
    u = _y(stages["y"], (plan.sy.R, plan.sy.M), t_spec.reshape(kx * Z, Y), False)
    out = np.zeros((2, plan.kxp, Z, Y), np.float32)
    out[0, :kx], out[1, :kx] = u.reshape(kx, Z, Y).real, u.reshape(kx, Z, Y).imag
    return out


def _y_inverse(plan, v, stages):
    Z, Y, _ = plan.shape
    kx = plan.kxh
    rows = _c64(v[0][:kx], v[1][:kx]).reshape(kx * Z, Y)
    return _y(stages["y"], (plan.sy.R, plan.sy.M), rows, True).reshape(kx, Z, Y)


def emulate_a(plan, stages, xt):
    return _pair_out(plan, _x_forward(stages["x"], xt), stages)


def emulate_c(plan, stages, v):
    return _x_inverse(stages["x"], _y_inverse(plan, v, stages)).transpose(1, 0, 2)


def emulate_cqa(plan, stages, v, view):
    blurred = _x_inverse(stages["x"], _y_inverse(plan, v, stages))
    q = view.transpose(1, 0, 2) * (np.float32(1.0) / blurred)
    return _pair_out(plan, _x_forward_half(stages["x"], q), stages)


def emulate_cu(plan, stages, v, psi, w, lam):
    return _rl_one(psi, emulate_c(plan, stages, v), w, lam, 1e-4)


def emulate_cua(plan, stages, v, psi, w, lam):
    new = emulate_cu(plan, stages, v, psi, w, lam)
    return new, _pair_out(plan, _x_forward_half(stages["x"], new.transpose(1, 0, 2)), stages)


def emulate_z(plan, st, u, k, conj_k, fwd_only):
    """z_stage_long on every slice: gather, the forward transform, K5's
    scatter of frequency split_freq(j) into row j, or K6's product with row
    j of K̂ there, the inverse and the natural scatter times 1/Z."""
    if st.kind == "direct":
        return _emulate_z_stage(plan, u, k, conj_k, fwd_only)
    Z = plan.shape[0]
    at = fp.spectrum_at(st, fp.split_perm(Z, (plan.sz.R, plan.sz.M)))
    out = np.zeros((2,) + u.shape[1:], np.float32)
    for kx in range(plan.kxh):
        w = _long_fft(st, _c64(u[0, kx], u[1, kx]), False)
        if fwd_only:
            res = w[at]
        else:
            kk = _c64(k[0, kx], k[1, kx])
            w[at] = w[at] * (np.conj(kk) if conj_k else kk)
            res = _long_fft(st, w, True)[:Z] * np.float32(1.0 / Z)
        out[0, kx], out[1, kx] = res.real, res.imag
    return out


# (Z, Y, X), the long axis and its (direct_max, radix_max): x and y at 40
# (four-step 5·8) and 88 (Bluestein, 11 refused, padded to 256 = 16·16); a
# split y of 256 = 2·128 as four-step 16·16; z likewise, and a split z
CASES = [
    ((8, 24, 40), "x", (8, 1024)), ((8, 24, 88), "x", (16, 8)),
    ((8, 40, 16), "y", (8, 1024)), ((8, 88, 16), "y", (16, 8)), ((8, 256, 16), "y", (16, 1024)),
    ((40, 24, 8), "z", (8, 1024)), ((88, 24, 8), "z", (16, 8)), ((256, 16, 8), "z", (16, 1024)),
]


def _ids(case):
    shape, axis, force = case
    return f"{axis}{shape}-{fp.make_fft_stages(dict(zip('zyx', shape))[axis], *force).kind}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_long_axis_passes_reproduce_the_plain_passes(case):
    """Each pass of the long axis's stages, emulated as fft_long.cu runs it,
    against the plain pass (the JAX package's dense matrices) at the same
    shape: K4, K7, K8, K9 and K10 where x or y is long, K5 and K6 (both
    conj_k) where z is."""
    shape, axis, force = case
    Z, Y, X = shape
    stages = _stages(shape, axis, force)
    assert stages[axis].kind != "direct"
    plan = fp.make_fused_plan(shape)
    c = fu.plan_tensors(plan, torch.device("cpu"))
    t = torch.from_numpy
    if axis == "z":
        rng = np.random.default_rng(Z)
        u, k = (rng.standard_normal((2, plan.kxp, Z, Y)).astype(np.float32) for _ in range(2))
        u[:, plan.kxh:] = k[:, plan.kxh:] = 0.0
        got = emulate_z(plan, stages["z"], u, None, False, True)
        assert _pair_rel(got, fu.pass_bf_plain(t(u[0]), t(u[1]), c)) <= PAIR_RTOL
        assert not got[:, plan.kxh:].any()
        for conj_k in (False, True):
            got = emulate_z(plan, stages["z"], u, k, conj_k, False)
            want = fu.pass_b_plain(t(u[0]), t(u[1]), t(k[0]), t(k[1]), c, conj_k)
            assert _pair_rel(got, want) <= PAIR_RTOL, conj_k
        return
    psi, view = _cqa_inputs(shape, 15)
    u = fu.pass_a_plain(t(psi), c)
    got = emulate_a(plan, stages, psi)
    assert _pair_rel(got, u) <= PAIR_RTOL and not got[:, plan.kxh:].any()
    v = [x.numpy() for x in u]
    assert _pair_rel([emulate_c(plan, stages, v)], [fu.pass_c_plain(*u, c)]) <= PAIR_RTOL
    got = emulate_cqa(plan, stages, v, view)
    assert _pair_rel(got, fu.pass_cqa_plain(*u, t(view), c)) <= PAIR_RTOL
    psi, g, w = _rl_inputs(shape, 16)
    vg = fu.pass_a_plain(t(g), c)
    for lam in (0.0, 0.006):
        want = fu.pass_cu_plain(*vg, t(psi), t(w), c, lam, 1e-4)
        _assert_psi(emulate_cu(plan, stages, [x.numpy() for x in vg], psi, w, lam), want, lam)
        want_psi, want_u = fu.pass_cua_plain(*vg, t(psi), np.float32(0.25), c, lam, 1e-4)
        got_psi, got_u = emulate_cua(plan, stages, [x.numpy() for x in vg], psi, np.float32(0.25),
                                     lam)
        _assert_psi(got_psi, want_psi, lam)
        assert _pair_rel(got_u, want_u) <= PAIR_RTOL


RUN = dict(interpret=True, precision="highest")


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_long_axis_passes_match_jax(axis):
    """One pass per long axis against the JAX package's in Pallas interpret
    mode: K8 with x four-step at (8, 24, 40), K10 (scalar weight, λ 0) with
    y Bluestein at (8, 88, 16), K6 with z four-step at (40, 24, 8)."""
    shape, force = {"x": ((8, 24, 40), (8, 1024)), "y": ((8, 88, 16), (16, 8)),
                    "z": ((40, 24, 8), (8, 1024))}[axis]
    stages = _stages(shape, axis, force)
    assert stages[axis].kind != "direct"
    plan, plan_j = fp.make_fused_plan(shape), fd.make_fused_plan(shape)
    if axis == "z":
        Z, Y, _ = shape
        rng = np.random.default_rng(17)
        u, k = (rng.standard_normal((2, plan.kxp, Z, Y)).astype(np.float32) for _ in range(2))
        u[:, plan.kxh:] = k[:, plan.kxh:] = 0.0
        want = fd._run_pass_b(*map(jnp.asarray, (u[0], u[1], k[0], k[1])), plan_j, **RUN)
        got = emulate_z(plan, stages["z"], u, k, False, False)
        assert _pair_rel(got, [np.asarray(x) for x in want]) <= PAIR_RTOL
        return
    if axis == "x":
        psi, view = _cqa_inputs(shape, 18)
        a = fd._run_pass_a(jnp.asarray(psi), plan_j, 8, True, "highest")
        want = fd._run_pass_cqa(*a, jnp.asarray(view), plan_j, 8, **RUN)
        got = emulate_cqa(plan, stages, [np.asarray(x) for x in a], view)
        assert _pair_rel(got, [np.asarray(x) for x in want]) <= PAIR_RTOL
        return
    psi, g, _ = _rl_inputs(shape, 19)
    a = fd._run_pass_a(jnp.asarray(g), plan_j, 8, True, "highest")
    want_psi, *want_u = fd._run_pass_cua(*a, jnp.asarray(psi), jnp.asarray(0.25), plan_j, 8, 0.0,
                                         1e-4, **RUN)
    got_psi, got_u = emulate_cua(plan, stages, [np.asarray(x) for x in a], psi, np.float32(0.25),
                                 0.0)
    _assert_psi(got_psi, want_psi, 0.0)
    assert _pair_rel(got_u, [np.asarray(x) for x in want_u]) <= PAIR_RTOL
