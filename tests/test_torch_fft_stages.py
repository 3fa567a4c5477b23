"""The function the FFT stages of K4 (pass A), K7 (pass C), K8 (pass CQA),
K9 (pass CU), K10 (pass CUA), K6 (pass B) and K5 (pass BF) compute, and the
tables they read.

On the card, these passes run as shared-memory mixed-radix FFT stages
(ops/csrc/fft_stage.cuh), which cannot run here.  So these tests hold what
the kernels must agree with, and the plan they follow:

* the plain passes (the JAX package's matrix-product stages, which
  chip_smoke.py holds the kernels against on the card) equal numpy's FFTs in
  the fused layout: (Kxp, Z, Y) re/im pairs, y (and K5's z) in the split
  order of ``split_perm``, pad rows zero; tolerance 1e-5 of max|·| over the
  pair;
* a numpy emulation of the kernels' in-place decimation-in-time stages,
  reading the tables of ``fused_plan.make_fft_stages`` as the kernels do,
  reproduces ``np.fft.fft`` (and its unscaled inverse) to 1e-6 of max|·| at
  every X from 8 to 1816, at Y of 200, 1016 and the split lengths, and at
  3640, 8168 = 8·1021 and 14528, the narrow tiles' lengths; so does the
  emulation of the z stage's transposed forward stages (natural order in,
  frequency f at ``pos[f]`` out), there too;
* the emulation of the whole z stage (load, forward, the kernel spectrum
  gathered at ``split_freq``, inverse, store) reproduces the plain K5 and K6
  to the tolerance of the plain passes;
* the emulation of the x and y stages as the kernels run them (the loads at
  ``pos[]``, the hermitian edge rule and split, the split order of y)
  reproduces the plain K4 and K7, and with K8 at each tile width of the x
  stage (16, 8, 4 and 2 sequences, the column pairs taken tile by tile,
  columns past Y zero); K8's three launches (K7's y stage,
  the x stage that holds the inverse x FFT, K2's quotient and the
  transposed forward stages, K4's y stage) reproduce the plain K8, K9's two
  (K7's with K1's update in place of its store) the plain K9, and K10's
  three (K8's with K1's update in place of the quotient) the plain K10, with
  per-voxel and scalar weights at λ 0 and 0.006; each also reproduces the
  JAX package's pass in Pallas interpret mode at 16³.  psi' at λ > 0 is
  held to rtol 2e-4, atol 5e-5, as tests/test_torch_kernels.py holds K1:
  PyTorch's CPU sqrt is an ulp off numpy's on some inputs near 1, which
  the Tikhonov step's cancellation amplifies;
* ``fused_limit`` admits every multiple of 8 on the card up to 2^25 and
  refuses past it; each length's plan is of the direct kind exactly where
  its stage has a tile and radices the kernels accept, by the tile rules
  read from ``fft_stage.cuh`` (each axis up to 14528 whose prime factors
  are at most 1024), with the same tables as before, and of the four-step
  or Bluestein kind past that (tests/test_torch_fused_long.py emulates
  those); the plans build at the new edges;
* the ctypes mirror of the kernels' plan struct keeps the C layout.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp

torch.set_num_threads(1)

PAIR_RTOL = 1e-5
FFT_RTOL = 1e-6
# (Z, Y, X): R = 1 with a lane-misaligned X, R = 2, R = 4, odd prime
# factors in both lengths (200 = 8·25, 264 = 8·3·11)
SHAPES = [(8, 24, 40), (8, 256, 16), (8, 512, 24), (8, 200, 264)]
X_LENGTHS = [8 * i for i in range(1, 228)]
Y_LENGTHS = [200, 256, 512, 968, 1016, 1024]
# lengths past the widest tiles: 4 sequences (3640), a generic radix of 1021
# (8168 = 8·1021), and 2 sequences filling shared memory (14528 = 64·227)
NARROW_LENGTHS = [3640, 8168, 14528]
# the tile widths of the FFT stages (fft_stage.cuh with_tile)
TILES = [16, 8, 4, 2]


def _pair_rel(got, want):
    got = np.concatenate([np.asarray(g).ravel() for g in got])
    want = np.concatenate([np.asarray(w).ravel() for w in want])
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plain(shape):
    plan = fp.make_fused_plan(shape)
    return plan, fu.plan_tensors(plan, torch.device("cpu"))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pass_a_plain_is_the_real_2d_fft(shape):
    Z, Y, X = shape
    plan, c = _plain(shape)
    xt = np.random.default_rng(0).uniform(-1.0, 2.0, (Z, X, Y)).astype(np.float32)
    u = fu.pass_a_plain(torch.from_numpy(xt), c)
    spec = np.fft.rfft2(xt.astype(np.float64), axes=(2, 1))  # (Z, Kx, Y), x halved
    spec = spec.transpose(1, 0, 2)[:, :, fp.split_perm(Y, (plan.sy.R, plan.sy.M))]
    want = np.zeros((2, plan.kxp, Z, Y))
    want[0, : plan.kxh], want[1, : plan.kxh] = spec.real, spec.imag
    assert _pair_rel(u, want) <= PAIR_RTOL
    assert all(not t[plan.kxh :].any() for t in u)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pass_c_plain_is_the_real_2d_inverse(shape):
    """The imaginary parts at the DC and Nyquist x-bins are ignored, as
    numpy's irfft ignores them; the pad rows of the input are never read."""
    Z, Y, X = shape
    plan, c = _plain(shape)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((2, plan.kxp, Z, Y)).astype(np.float32)
    v[:, plan.kxh :] = 0.0
    got = fu.pass_c_plain(torch.from_numpy(v[0]), torch.from_numpy(v[1]), c).numpy()
    natural = np.empty((plan.kxh, Z, Y), np.complex128)
    natural[..., fp.split_perm(Y, (plan.sy.R, plan.sy.M))] = (v[0] + 1j * v[1])[: plan.kxh]
    want = np.fft.irfft2(natural.transpose(1, 0, 2), s=(Y, X), axes=(2, 1))
    assert got.shape == (Z, X, Y)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= PAIR_RTOL


def _stage_tables(stages: fp.FftStages, inverse: bool):
    """Per stage, in the order run_stages runs them: (r, m, twiddles (r, m),
    r-point DFT matrix), the roots of radix 2, 4 and 8 built in and the
    others read from the table after the twiddles."""
    n = stages.n
    table = np.conj(stages.tw) if inverse else stages.tw
    roots_at, m, out = n - 1, 1, []
    for r in stages.radices:
        tw = np.ones((r, m), np.complex64)
        tw[1:] = table[m - 1 : m - 1 + (r - 1) * m].reshape(r - 1, m)
        if r in (2, 4, 8):
            roots = np.exp((1j if inverse else -1j) * 2 * np.pi * np.arange(r) / r)
        else:
            roots, roots_at = table[roots_at : roots_at + r], roots_at + r
        out.append((r, m, tw, roots.astype(np.complex64)[np.outer(np.arange(r), np.arange(r)) % r]))
        m *= r
    assert roots_at == stages.tw.size
    return out


def _run_stages(stages: fp.FftStages, buf: np.ndarray, inverse: bool) -> np.ndarray:
    """run_stages in complex64 on (n, P) sequences already in digit-reversed
    order: each stage's twiddles, then its r-point DFTs, in place."""
    n = stages.n
    for r, m, tw, dft in _stage_tables(stages, inverse):
        y = buf.reshape(n // (r * m), r, m, -1) * tw[..., None]  # value t*m + k' of block b
        buf = np.einsum("kt,btms->bkms", dft, y).astype(np.complex64).reshape(buf.shape)
    return buf


def _run_stages_dif(stages: fp.FftStages, buf: np.ndarray) -> np.ndarray:
    """run_stages_dif in complex64 on (n, P) sequences in natural order: the
    transposed stages in reverse order, each r-point DFT before its
    twiddles; frequency f ends at pos[f]."""
    n = stages.n
    for r, m, tw, dft in reversed(_stage_tables(stages, False)):
        y = np.einsum("kt,btms->bkms", dft, buf.reshape(n // (r * m), r, m, -1))
        buf = (y * tw[..., None]).astype(np.complex64).reshape(buf.shape)
    return buf


def _emulate(stages: fp.FftStages, x: np.ndarray, inverse: bool) -> np.ndarray:
    """The x and y stages' transform: the digit-reversed load, then
    run_stages."""
    buf = np.empty((stages.n, 1), np.complex64)
    buf[stages.pos, 0] = x.astype(np.complex64)
    return _run_stages(stages, buf, inverse)[:, 0]


@pytest.mark.parametrize("n", X_LENGTHS + Y_LENGTHS + NARROW_LENGTHS)
def test_stage_emulation_reproduces_numpy_fft(n):
    stages = fp.make_fft_stages(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for inverse, want in ((False, np.fft.fft(x)), (True, np.fft.ifft(x) * n)):
        got = _emulate(stages, x, inverse)
        assert float(np.abs(got - want).max() / np.abs(want).max()) <= FFT_RTOL, inverse


# Z of the z stage: R = 1, 2 and 4 split lengths, radices 5, 3 and 11, 23,
# 89, the old edge of the card (736), and the narrow tiles' lengths
Z_LENGTHS = [8, 32, 200, 256, 264, 512, 712, 736] + NARROW_LENGTHS


@pytest.mark.parametrize("n", Z_LENGTHS)
def test_transposed_stages_reproduce_numpy_fft(n):
    """The z stage's forward transform: natural order in, frequency f at
    pos[f] out, where the inverse run_stages takes its input."""
    stages = fp.make_fft_stages(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    got = _run_stages_dif(stages, x.astype(np.complex64))[stages.pos]
    want = np.fft.fft(x, axis=0)
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= FFT_RTOL


def _z_inputs(Z, seed):
    """A (Z, Y, X) plan with pad x-frequencies, and u and K̂ pairs whose pad
    rows are zero (as pass A leaves them)."""
    plan = fp.make_fused_plan((Z, 16, 8))
    rng = np.random.default_rng(seed)
    u, k = (rng.standard_normal((2, plan.kxp, Z, 16)).astype(np.float32) for _ in range(2))
    u[:, plan.kxh :] = 0.0
    k[:, plan.kxh :] = 0.0
    return plan, u, k


@pytest.mark.parametrize("conj_k", [False, True])
@pytest.mark.parametrize("Z", [32, 256, 512, 200, 736, 744, 1824])
def test_z_stage_plain_passes_are_the_z_fft(Z, conj_k):
    """Plain K6 is ifft(fft(u, z) · K̂, z) with K̂ taken from z's split order
    (or its conjugate); plain K5 is fft(u, z) stored in the split order."""
    plan, u, k = _z_inputs(Z, Z + conj_k)
    c = fu.plan_tensors(plan, torch.device("cpu"))
    perm = fp.split_perm(Z, (plan.sz.R, plan.sz.M))
    uc = (u[0] + 1j * u[1]).astype(np.complex128)
    k_nat = np.empty_like(uc)
    k_nat[:, perm] = k[0] + 1j * k[1]
    spec = np.fft.fft(uc, axis=1)
    want = np.fft.ifft(spec * (np.conj(k_nat) if conj_k else k_nat), axis=1)
    got = fu.pass_b_plain(*map(torch.from_numpy, u), *map(torch.from_numpy, k), c, conj_k)
    assert _pair_rel(got, (want.real, want.imag)) <= PAIR_RTOL
    got = fu.pass_bf_plain(*map(torch.from_numpy, u), c)
    assert _pair_rel(got, (spec[:, perm].real, spec[:, perm].imag)) <= PAIR_RTOL


def _emulate_z_stage(plan, u, k, conj_k, fwd_only):
    """z_kernel on every slice: the natural-order load of each y column, the
    transposed forward stages, then pass BF's store of frequency
    split_freq(j) from pos[split_freq(j)] into row j, or pass B's product
    with row j of K̂ at the same place, the inverse stages and the natural
    store times 1/Z.  Pad slices come out zero."""
    Z = plan.shape[0]
    stages = fp.make_fft_stages(Z)
    freq = fp.split_perm(Z, (plan.sz.R, plan.sz.M))  # split_freq(j) for each row j
    at = stages.pos[freq]
    out = np.zeros((2,) + u.shape[1:], np.float32)
    for kx in range(plan.kxh):
        buf = _run_stages_dif(stages, (u[0, kx] + 1j * u[1, kx]).astype(np.complex64))
        if fwd_only:
            res = buf[at]
        else:
            kk = (k[0, kx] + 1j * k[1, kx]).astype(np.complex64)
            buf[at] *= np.conj(kk) if conj_k else kk
            res = _run_stages(stages, buf, True) * np.float32(1.0 / Z)
        out[0, kx], out[1, kx] = res.real, res.imag
    return out


@pytest.mark.parametrize("conj_k", [False, True])
@pytest.mark.parametrize("Z", [32, 256, 512, 200, 736, 744, 1824])
def test_z_stage_emulation_reproduces_the_plain_passes(Z, conj_k):
    plan, u, k = _z_inputs(Z, 2 * Z + conj_k)
    c = fu.plan_tensors(plan, torch.device("cpu"))
    ut, kt = tuple(map(torch.from_numpy, u)), tuple(map(torch.from_numpy, k))
    got = _emulate_z_stage(plan, u, k, conj_k, fwd_only=False)
    assert _pair_rel(got, fu.pass_b_plain(*ut, *kt, c, conj_k)) <= PAIR_RTOL
    got = _emulate_z_stage(plan, u, None, False, fwd_only=True)
    assert _pair_rel(got, fu.pass_bf_plain(*ut, c)) <= PAIR_RTOL


def _c64(re, im):
    out = np.empty(np.shape(re), np.complex64)
    out.real, out.imag = re, im
    return out


def _emulate_y_stage(stages, rows, split, inverse):
    """y_kernel on complex rows (g, Y).  Inverse: position j holds frequency
    split_freq(j), loaded at pos[split_freq(j)]; the inverse stages; natural
    y out times 1/Y.  Forward: natural y loaded at pos[y]; frequency
    split_freq(j) stored at j."""
    Y = stages.n
    freq = fp.split_perm(Y, split)
    buf = np.empty((Y, rows.shape[0]), np.complex64)
    if inverse:
        buf[stages.pos[freq]] = rows.T
        return (_run_stages(stages, buf, True) * np.float32(1.0 / Y)).T
    buf[stages.pos] = rows.T
    return _run_stages(stages, buf, False)[freq].T


def _tiled(a, seq):
    """``a`` (..., Y) as the x stage's blocks see it: tiles of 2·seq columns,
    (..., tiles, 2·seq), the columns past Y zero."""
    pad = -a.shape[-1] % (2 * seq)
    a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), a.dtype)], axis=-1)
    return a.reshape(a.shape[:-1] + (-1, 2 * seq))


def _pair_columns(vol, seq):
    """(X, Z, Y) real columns -> (X, Z·tiles·seq) sequences, tile by tile:
    column 2s of a tile the real part of the tile's sequence s, column
    2s + 1 its imaginary part."""
    tiles = _tiled(vol, seq)
    return _c64(tiles[..., 0::2], tiles[..., 1::2]).reshape(vol.shape[0], -1)


def _unpair_columns(buf, Z, Y, seq):
    """The inverse of :func:`_pair_columns`; the columns past Y dropped."""
    X = buf.shape[0]
    seqs = buf.reshape(X, Z, -1, seq)
    vol = np.empty(seqs.shape[:-1] + (2 * seq,), np.float32)
    vol[..., 0::2], vol[..., 1::2] = seqs.real, seqs.imag
    return vol.reshape(X, Z, -1)[..., :Y]


def _load_half_spectra(stages, t, seq):
    """load_half_spectra, tile by tile: the (Kx, Z, Y) half spectra A (even
    columns of a tile) and B (odd) of each column pair become
    Z_k = A_k + i B_k at pos[k] and Z_{X-k} = conj A_k + i conj B_k at
    pos[X-k]; at k = 0 and X/2 the imaginary parts are dropped and only
    pos[k] is written."""
    X = stages.n
    kx = t.shape[0]
    tiles = _tiled(t, seq)
    re, im = tiles.real, tiles.imag.copy()
    k = np.arange(kx)
    edge = (k == 0) | (2 * k == X)
    im[edge] = 0.0
    a_re, a_im, b_re, b_im = re[..., 0::2], im[..., 0::2], re[..., 1::2], im[..., 1::2]
    n = a_re[0].size
    buf = np.empty((X, n), np.complex64)
    buf[stages.pos[k]] = _c64(a_re - b_im, a_im + b_re).reshape(kx, n)
    buf[stages.pos[X - k[~edge]]] = _c64(a_re + b_im, b_re - a_im)[~edge].reshape(-1, n)
    return buf


def _store_half_spectra(F, at, Z, Y, seq):
    """store_half_spectra, tile by tile: A_k = (F_k + conj F_{X-k}) / 2 into
    the even columns of a tile, B_k = (F_k - conj F_{X-k}) / 2i into the odd
    ones, F_k read at at[k], for k < Kx; the columns past Y not stored."""
    X = F.shape[0]
    kx = X // 2 + 1
    k = np.arange(kx)
    a, b = F[at[k]], F[at[(X - k) % X]]
    out = np.empty((kx, Z, F.shape[1] // (Z * seq), 2 * seq), np.complex64)
    half = lambda v: (v * np.float32(0.5)).reshape(out.shape[:-1] + (seq,))
    out[..., 0::2] = _c64(half(a.real + b.real), half(a.imag - b.imag))
    out[..., 1::2] = _c64(half(a.imag + b.imag), half(b.real - a.real))
    return out.reshape(kx, Z, -1)[..., :Y]


def _fused_stages(plan):
    """(Z, Y, X, Kx, y split, x stages, y stages) of a plan."""
    Z, Y, X = plan.shape
    return Z, Y, X, plan.kxh, (plan.sy.R, plan.sy.M), fp.make_fft_stages(X), fp.make_fft_stages(Y)


def _y_inverse(plan, v):
    """K7's and K8's first launch on a (re, im) pair: (Kx, Z, Y) complex, y
    natural."""
    Z, Y, _, kx, split, _, fy = _fused_stages(plan)
    rows = _c64(v[0][:kx], v[1][:kx]).reshape(kx * Z, Y)
    return _emulate_y_stage(fy, rows, split, True).reshape(kx, Z, Y)


def _x_inverse(plan, t, seq):
    """K7's x stage up to its store: natural x, times 1/X, (X, Z, Y)."""
    Z, Y, X, _, _, fx, _ = _fused_stages(plan)
    buf = _run_stages(fx, _load_half_spectra(fx, t, seq), True)
    return _unpair_columns(buf, Z, Y, seq) * np.float32(1.0 / X)


def _y_forward(plan, t):
    """K4's and K8's last launch: the (re, im) pair, pad rows zero."""
    Z, Y, _, kx, split, _, fy = _fused_stages(plan)
    u = _emulate_y_stage(fy, t.reshape(kx * Z, Y), split, False).reshape(kx, Z, Y)
    out = np.zeros((2, plan.kxp, Z, Y), np.float32)
    out[0, :kx], out[1, :kx] = u.real, u.imag
    return out


def _emulate_pass_a(plan, xt, seq=16):
    """K4's two launches on a (Z, X, Y) volume, the x stage in tiles of
    ``seq`` sequences."""
    Z, Y, X, _, _, fx, _ = _fused_stages(plan)
    pairs = _pair_columns(xt.transpose(1, 0, 2), seq)
    buf = np.empty_like(pairs)
    buf[fx.pos] = pairs
    F = _run_stages(fx, buf, False)
    return _y_forward(plan, _store_half_spectra(F, np.arange(X), Z, Y, seq))


def _emulate_pass_c(plan, v, seq=16):
    """K7's two launches: the (Z, X, Y) volume."""
    return _x_inverse(plan, _y_inverse(plan, v), seq).transpose(1, 0, 2)


def _forward_half(plan, vol, seq):
    """The forward half of K8's and K10's x stage, then their last launch:
    the transposed forward stages on the (X, Z, Y) values in natural order,
    whose frequency f sits at pos[f] for the split, and K4's y stage."""
    Z, Y, _, _, _, fx, _ = _fused_stages(plan)
    F = _run_stages_dif(fx, _pair_columns(vol, seq))
    return _y_forward(plan, _store_half_spectra(F, fx.pos, Z, Y, seq))


def _emulate_pass_cqa(plan, v, view, seq=16):
    """K8's three launches; the x stage keeps K7's blurred column and takes
    lmvn::quotient_one against the view before the forward half."""
    blurred = _x_inverse(plan, _y_inverse(plan, v), seq)
    return _forward_half(plan, view.transpose(1, 0, 2) * (np.float32(1.0) / blurred), seq)


def _rl_one(psi, integral, w, lam, min_value):
    """lmvn::rl_one (ops/csrc/rl_update.cuh) in float32, in its order:
    value = psi·integral; Tikhonov (1/λ)·(sqrt(1 + (2λ)·value) − 1) where
    λ > 0; min_value where value <= 0 or the result is not finite, else at
    least min_value; psi' = w·(next − psi) + psi."""
    f32 = np.float32
    min_value = f32(min_value)
    value = psi * integral
    t = value
    if lam > 0:
        with np.errstate(invalid="ignore"):
            t = (f32(1.0) / f32(lam)) * (np.sqrt(f32(1.0) + (f32(2.0) * f32(lam)) * value) - f32(1.0))
    value = np.where(value > 0, t, min_value)
    nxt = np.where(np.isnan(value) | np.isinf(value), min_value, np.maximum(value, min_value))
    return (f32(w) * (nxt - psi) + psi).astype(np.float32)


def _emulate_pass_cu(plan, v, psi, w, lam, min_value):
    """K9's two launches: K7's, with rl_one on the value K7 stores."""
    return _rl_one(psi, _emulate_pass_c(plan, v), w, lam, min_value)


def _emulate_pass_cua(plan, v, psi, w, lam, min_value):
    """K10's three launches: K9's psi', kept for the forward half."""
    new = _emulate_pass_cu(plan, v, psi, w, lam, min_value)
    return new, _forward_half(plan, new.transpose(1, 0, 2), 16)


def _cqa_inputs(shape, seed):
    """psi and the view on [1, 100] and [1, 200].  K8 takes v = pass A of
    psi, so the blurred estimate is psi and the quotient far from a pole."""
    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    view = rng.uniform(1.0, 200.0, (Z, X, Y)).astype(np.float32)
    return psi, view


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_x_and_y_stage_emulation_reproduces_plain_k4_and_k7(shape):
    plan, c = _plain(shape)
    psi, _ = _cqa_inputs(shape, 3)
    u = fu.pass_a_plain(torch.from_numpy(psi), c)
    assert _pair_rel(_emulate_pass_a(plan, psi), u) <= PAIR_RTOL
    v = [t.numpy() for t in u]
    assert _pair_rel([_emulate_pass_c(plan, v)], [fu.pass_c_plain(*u, c)]) <= PAIR_RTOL


@pytest.mark.parametrize("seq", TILES[1:])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_narrow_x_tiles_reproduce_plain_k4_k7_and_k8(shape, seq):
    """The x stage with 8, 4 and 2 sequences a block (X past 1816, 3632 and
    7264 on the card): each block pairs the columns of its own tile of
    2·seq, the columns past Y zero, as the 16-sequence tile of the tests
    above does; K4, K7 and K8 reproduce their plain versions."""
    plan, c = _plain(shape)
    psi, view = _cqa_inputs(shape, 9)
    u = fu.pass_a_plain(torch.from_numpy(psi), c)
    assert _pair_rel(_emulate_pass_a(plan, psi, seq), u) <= PAIR_RTOL
    v = [t.numpy() for t in u]
    assert _pair_rel([_emulate_pass_c(plan, v, seq)], [fu.pass_c_plain(*u, c)]) <= PAIR_RTOL
    want = fu.pass_cqa_plain(*u, torch.from_numpy(view), c)
    assert _pair_rel(_emulate_pass_cqa(plan, v, view, seq), want) <= PAIR_RTOL


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cqa_emulation_reproduces_plain_k8(shape):
    """K8's three launches: K7's inverse y stage, the x stage (inverse x
    FFT, blurred = value · 1/X, q = view · (1/blurred), the transposed
    forward stages, the split read at pos[k] and pos[X−k]) and K4's forward
    y stage, with the pad rows of the output zero."""
    plan, c = _plain(shape)
    psi, view = _cqa_inputs(shape, 4)
    u = fu.pass_a_plain(torch.from_numpy(psi), c)
    want = fu.pass_cqa_plain(*u, torch.from_numpy(view), c)
    got = _emulate_pass_cqa(plan, [t.numpy() for t in u], view)
    assert _pair_rel(got, want) <= PAIR_RTOL
    assert not got[:, plan.kxh :].any()


def _rl_inputs(shape, seed):
    """psi on [1, 100], an integral-like g on [-0.2, 2] (some values <= 0:
    the clamp), weights on [0, 0.5].  K9 and K10 take v = pass A of g, so
    the integral is g."""
    Z, Y, X = shape
    rng = np.random.default_rng(seed)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    g = rng.uniform(-0.2, 2.0, (Z, X, Y)).astype(np.float32)
    w = rng.uniform(0.0, 0.5, (Z, X, Y)).astype(np.float32)
    return psi, g, w


def _assert_psi(got, want, lam):
    want = np.asarray(want)
    if lam > 0:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    else:
        assert _pair_rel([got], [want]) <= PAIR_RTOL


@pytest.mark.parametrize("lam", [0.0, 0.006])
@pytest.mark.parametrize("weights", ["voxel", "scalar"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cu_emulation_reproduces_plain_k9(shape, weights, lam):
    """K9's two launches: K7's inverse y stage, then K7's x stage (the loads
    at pos[], the edge rule, the inverse stages, value · 1/X) with
    lmvn::rl_one against psi and w in place of K7's store."""
    plan, c = _plain(shape)
    psi, g, w = _rl_inputs(shape, 6)
    wt = w if weights == "voxel" else np.float32(0.25)
    v = fu.pass_a_plain(torch.from_numpy(g), c)
    want = fu.pass_cu_plain(*v, torch.from_numpy(psi), torch.from_numpy(w) if weights == "voxel"
                            else 0.25, c, lam, 1e-4)
    _assert_psi(_emulate_pass_cu(plan, [t.numpy() for t in v], psi, wt, lam, 1e-4), want, lam)


@pytest.mark.parametrize("lam", [0.0, 0.006])
@pytest.mark.parametrize("weights", ["voxel", "scalar"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cua_emulation_reproduces_plain_k10(shape, weights, lam):
    """K10's three launches: K9's, with psi' kept for the transposed forward
    stages, the split read at pos[k] and pos[X−k], and K4's y stage; the pad
    rows of u zero."""
    plan, c = _plain(shape)
    psi, g, w = _rl_inputs(shape, 7)
    wt = w if weights == "voxel" else np.float32(0.25)
    v = fu.pass_a_plain(torch.from_numpy(g), c)
    want_psi, want_u = fu.pass_cua_plain(
        *v, torch.from_numpy(psi), torch.from_numpy(w) if weights == "voxel" else 0.25, c, lam,
        1e-4)
    got_psi, got_u = _emulate_pass_cua(plan, [t.numpy() for t in v], psi, wt, lam, 1e-4)
    _assert_psi(got_psi, want_psi, lam)
    assert _pair_rel(got_u, want_u) <= PAIR_RTOL
    assert not got_u[:, plan.kxh :].any()


@pytest.mark.parametrize("which", ["cu", "cua"])
def test_cu_and_cua_emulation_match_jax(which):
    """The same emulations against the JAX package's pass CU (per-voxel
    weights, λ 0.006) and pass CUA (scalar weight, λ 0) in Pallas
    interpret mode at 16³."""
    shape = (16, 16, 16)
    psi, g, w = _rl_inputs(shape, 8)
    plan_j = fd.make_fused_plan(shape)
    run = dict(interpret=True, precision="highest")
    a = fd._run_pass_a(jnp.asarray(g), plan_j, 8, True, "highest")
    v, plan = [np.asarray(t) for t in a], fp.make_fused_plan(shape)
    if which == "cu":
        want = fd._run_pass_cu(*a, jnp.asarray(psi), jnp.asarray(w), plan_j, 8, 0.006, 1e-4, **run)
        _assert_psi(_emulate_pass_cu(plan, v, psi, w, 0.006, 1e-4), want, 0.006)
        return
    want_psi, *want_u = fd._run_pass_cua(*a, jnp.asarray(psi), jnp.asarray(0.25), plan_j, 8, 0.0,
                                         1e-4, **run)
    got_psi, got_u = _emulate_pass_cua(plan, v, psi, np.float32(0.25), 0.0, 1e-4)
    _assert_psi(got_psi, want_psi, 0.0)
    assert _pair_rel(got_u, [np.asarray(t) for t in want_u]) <= PAIR_RTOL


def test_cqa_emulation_matches_jax_pass_cqa():
    """The same emulation against the JAX package's pass CQA (its Pallas
    kernel in interpret mode, ``precision="highest"``) at 16³."""
    shape = (16, 16, 16)
    psi, view = _cqa_inputs(shape, 5)
    plan_j = fd.make_fused_plan(shape)
    a = fd._run_pass_a(jnp.asarray(psi), plan_j, 8, True, "highest")
    want = fd._run_pass_cqa(*a, jnp.asarray(view), plan_j, 8, interpret=True, precision="highest")
    got = _emulate_pass_cqa(fp.make_fused_plan(shape), [np.asarray(t) for t in a], view)
    assert _pair_rel(got, [np.asarray(t) for t in want]) <= PAIR_RTOL


@pytest.mark.parametrize("n", [8, 200, 256, 264, 808, 832, 1016, 1024])
def test_stage_tables(n):
    """Radices in the kernels' range, in the order the stages run (generic
    primes first, the power of two last); pos a permutation; the twiddle
    table n - 1 values, then r roots per radix other than 2, 4, 8."""
    st = fp.make_fft_stages(n)
    assert int(np.prod(st.radices)) == n and len(st.radices) <= fp.FFT_MAX_STAGES
    assert all(2 <= r <= 1024 for r in st.radices)
    small = [r for r in st.radices if r in (2, 3, 4, 5, 7, 8)]
    assert list(st.radices[-len(small):]) == small
    assert sorted(st.pos.tolist()) == list(range(n)) and st.pos.dtype == np.int32
    odd = sum(r for r in st.radices if r not in (2, 4, 8))
    assert st.tw.dtype == np.complex64 and st.tw.size == n - 1 + odd
    # stage j's twiddles W_{L_j}^{t k'} at m_j - 1 + (t - 1) m_j + k'
    m = 1
    for r in st.radices:
        t, k = np.meshgrid(np.arange(1, r), np.arange(m), indexing="ij")
        want = np.exp(-2j * np.pi * t * k / (r * m)).ravel()
        np.testing.assert_allclose(st.tw[m - 1 : m - 1 + (r - 1) * m], want, rtol=0, atol=1e-7)
        m *= r


def _header_tile_rules():
    """The tile rules of ``ops/csrc/fft_stage.cuh``, from its constants and
    the three functions that apply them: (x_seq, y_rows, z_cols, largest
    radix of a generic stage), each rule a function of the length."""
    header = (Path(fu.__file__).parent / "csrc" / "fft_stage.cuh").read_text()

    def const(name):
        expr = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);", header).group(1)
        factors = [f.strip() for f in expr.split("*")]
        return int(np.prod([const(f) if f.startswith("k") else int(f) for f in factors]))

    flat = " ".join(header.split())
    assert "inline int x_seq(int X) { return widest_tile(kXSeqMax, X); }" in flat
    assert ("inline int y_rows(int Y) { return kYRowsMax * sizeof(float2) * Y <= kYSmemTarget"
            " ? kYRowsMax : widest_tile(kYRowsMax / 2, Y); }") in flat
    assert "inline int z_cols(int Z) { return widest_tile(kZColsMax, Z); }" in flat
    assert "if (sizeof(float2) * p * n <= kSmemMax) return p;" in flat
    smem, least = const("kSmemMax"), const("kMinTile")

    def widest_tile(widest, n):
        p = widest
        while p >= least:
            if 8 * p * n <= smem:
                return p
            p //= 2
        return 0

    y_max, y_target = const("kYRowsMax"), const("kYSmemTarget")
    return (
        lambda n: widest_tile(const("kXSeqMax"), n),
        lambda n: y_max if y_max * 8 * n <= y_target else widest_tile(y_max // 2, n),
        lambda n: widest_tile(const("kZColsMax"), n),
        const("kMaxGenericRadix"),
    )


# long lengths sampled past the sweep: four-step (20000 = 125·160, 2^20,
# 2^25 = 4096·8192) and Bluestein (8·14519, 8·65537, 8·4194301 the longest)
LONG_SAMPLES = [16392, 17280, 20000, 65536, 116152, 524296, 2**20, 33554408, 2**25]


@pytest.mark.parametrize("axis", ["X", "Y", "Z"])
def test_fused_limit_admits_only_fft_plans_the_kernels_accept(axis):
    """``plan_ok`` of ``ops/csrc/fused.cu`` in Python, with the tile rules
    read from ``fft_stage.cuh``: a length's plan is direct exactly where its
    stage has a tile (``_x_seq``, ``_y_rows``, ``_z_cols`` agree with the
    header's rule at every length) and its stages are at most 16, of radix
    2 to the largest generic radix, with the tables of ``fft_radices``;
    past that it is four-step where the length splits into two direct ones,
    else Bluestein.  ``fused_limit`` admits every multiple of 8 on the card
    up to 2^25 (the sweep to 16384 and the samples past it) and refuses
    past it.  Each tile keeps its width up to the old edges (x and z 16 to
    1816, y 16 to 512 and 8 to 3632); 8248 = 8·1031 takes Bluestein and
    14536 the four-step."""
    x_seq, y_rows, z_cols, max_radix = _header_tile_rules()
    rule, mirror = {"X": (x_seq, fu._x_seq), "Y": (y_rows, fu._y_rows),
                    "Z": (z_cols, fu._z_cols)}[axis]
    kinds = {}
    for n in list(range(8, 16384 + 1, 8)) + LONG_SAMPLES:
        if n <= 16384:
            assert mirror(n) == rule(n), n
        zxy = {"X": (8, n, 8), "Y": (8, 8, n), "Z": (n, 8, 8)}[axis]
        assert fu.fused_limit(zxy, "cuda") is None, n
        kind, sizes = fp.plan_kind(n)
        radices = fp.fft_radices(n) if n <= 16384 else ()
        direct = (n <= 16384 and rule(n) > 0 and len(radices) <= fp.FFT_MAX_STAGES
                  and all(2 <= r <= max_radix for r in radices))
        assert (kind == "direct") == direct, n
        if kind == "four_step":
            assert sizes[0] * sizes[1] == n and all(fp.is_direct(s) for s in sizes), n
        elif kind == "bluestein":
            (m,) = sizes
            assert m == 1 << (2 * n - 2).bit_length() and fp.plan_kind(m)[0] != "bluestein", n
        kinds[n] = kind
    for n in range(8, 14529, 200):  # the shared-memory plans and their tables, as before
        if kinds[n] == "direct":
            st = fp.make_fft_stages(n)
            odd = sum(r for r in st.radices if r not in (2, 4, 8))
            assert st.kind == "direct" and st.radices == fp.fft_radices(n) and not st.parts
            assert st.tw.size == n - 1 + odd and sorted(st.pos.tolist()) == list(range(n))
    admitted = [n for n, k in kinds.items() if k == "direct"]
    assert max_radix == 1024 and admitted[-1] == 14528
    assert set(range(8, 8193, 8)) <= set(admitted)
    assert kinds[8248] == kinds[116152] == kinds[33554408] == "bluestein"
    assert kinds[14536] == kinds[16384] == kinds[2**25] == "four_step" and kinds[8168] == "direct"
    over = {"X": (8, 2**25 + 8, 8), "Y": (8, 8, 2**25 + 8), "Z": (2**25 + 8, 8, 8)}[axis]
    assert "past 2^25" in fu.fused_limit(over, "cuda")
    widest = {"X": [(1816, 16), (1824, 8), (3632, 8), (3640, 4), (7264, 4), (7272, 2)],
              "Y": [(512, 16), (520, 8), (3632, 8), (3640, 4), (7264, 4), (7272, 2)],
              "Z": [(736, 16), (1816, 16), (1824, 8), (3640, 4), (7272, 2)]}[axis]
    assert [(n, rule(n)) for n, _ in widest] == widest
    assert rule(14528) == 2 and rule(14536) == 0


def test_build_compiles_every_tile_width_the_stages_dispatch():
    """``with_tile`` in ``fft_stage.cuh`` dispatches to the widths 16, 8, 4
    and 2, each of which ``LMVN_FFT_TILE`` declares extern; ``ops/_build``
    compiles ``fft_tiles.cu`` once per width (``-DLMVN_TILE``), so every
    launch the dispatch can reach is instantiated exactly once."""
    from libmultiviewnative_torch.ops import _build

    header = (Path(fu.__file__).parent / "csrc" / "fft_stage.cuh").read_text()
    body = header[header.index("int with_tile(int p, Fn fn)"):header.index("// ---", header.index("int with_tile"))]
    cases = [int(n) for n in re.findall(r"case (\d+):", body)]
    externs = [int(n) for n in re.findall(r"^LMVN_FFT_TILE\(extern, (\d+)\)", header, re.M)]
    assert cases == externs == list(_build._TILES) == TILES
    units = [flags for src, flags, _ in _build._UNITS if src == "fft_tiles.cu"]
    assert units == [(f"-DLMVN_TILE={p}",) for p in TILES]
    assert sorted({src for src, _, _ in _build._UNITS}) == sorted(_build._SOURCES)


def test_build_hash_covers_each_units_flags(monkeypatch):
    """The library's directory is keyed by a hash that changes with a
    unit's flags alone (a tile width added or dropped), so no stale library
    is reused."""
    from libmultiviewnative_torch.ops import _build

    before = _build._digest()
    assert _build._digest() == before
    monkeypatch.setattr(_build, "_UNITS", _build._UNITS[:-1])
    assert _build._digest() != before
    monkeypatch.setattr(_build, "_UNITS", _build._UNITS[:-1] + (
        ("fft_tiles.cu", ("-DLMVN_TILE=1",), "fft_tiles1"),))
    assert _build._digest() != before


# (Z, Y, X) past the old edges: the two full-width shapes of chip_smoke.py's
# phase 29, and X, Y and Z at the first lengths of the 8- and 4-wide tiles
EDGE_PLANS = [(256, 1024, 2048), (1024, 512, 512), (8, 8, 1824), (8, 16, 3640),
              (8, 1824, 8), (8, 3640, 16), (1824, 8, 8), (3640, 16, 8)]


@pytest.mark.parametrize("shape", EDGE_PLANS, ids=str)
def test_plans_build_past_the_old_edges(shape):
    """``make_fused_plan`` builds at the new edges, with the FFT stage plans
    the CUDA passes read, and its plain constants load on the CPU.  (At
    7272 and up an unsplit y or z stage's dense matrices take GBs in
    float64: those plans are built on the card's host, in phase 29.)"""
    Z, Y, X = shape
    plan = fp.make_fused_plan(shape)
    assert plan.shape == shape and plan.kxh == X // 2 + 1 and plan.kxp % 8 == 0
    assert plan.fxp.shape == (2 * plan.kxp, X) and plan.sy.R * plan.sy.M == Y
    assert plan.sz.R * plan.sz.M == Z
    assert fu.fused_limit((Z, X, Y), "cuda") is None
    for n in shape:
        st = fp.make_fft_stages(n)
        assert int(np.prod(st.radices)) == n and sorted(st.pos.tolist()) == list(range(n))
    c = fu.plan_tensors(plan, torch.device("cpu"))
    assert c.args is None and c.fxp.shape == (2 * plan.kxp, X)


@pytest.mark.parametrize("n", [1824, 3640, 7264, 7272, 8168, 14528])
def test_stage_tables_at_the_narrow_tiles(n):
    """The FFT stage tables at each narrow tile's lengths: a direct plan
    (``LmvnFft.kind`` 0, no parts, no chirp), radices in the kernels' range
    (8168 = 8·1021 runs a generic stage of 1021, 14528 = 64·227 one of
    227), pos a permutation, and the twiddles of every stage."""
    st = fp.make_fft_stages(n)
    assert st.kind == "direct" and st.parts == () and st.m == 0 and st.chirp is None
    assert int(np.prod(st.radices)) == n and len(st.radices) <= fp.FFT_MAX_STAGES
    assert all(2 <= r <= 1024 for r in st.radices)
    assert sorted(st.pos.tolist()) == list(range(n))
    odd = sum(r for r in st.radices if r not in (2, 4, 8))
    assert st.tw.size == n - 1 + odd


def test_plan_struct_mirrors_the_c_layout():
    """``LmvnFft`` (fft_stage.cuh): two ints, int radix[16], two pointers,
    what the stage kernels read (they copy it to their stack, so it holds
    no more); ``LmvnAxis``: an ``LmvnFft``, the kind and the Bluestein length
    m (two ints), the chirp and bhat pointers and part[2], two pointers to
    the plans a long one runs, in the header's order; ``LmvnFusedPlan``
    (fused.cu): nine ints, then fx, fy and fz, the first on the next 8-byte
    boundary.  The kinds and two constants are the headers'."""
    header = (Path(fu.__file__).parent / "csrc" / "fft_stage.cuh").read_text()

    def fields(struct):
        body = header[header.index(f"struct {struct} {{"):header.index("};", header.index(f"struct {struct} {{"))]
        decls = re.sub(r"//[^\n]*", "", body.split("{", 1)[1]).split(";")
        return [re.findall(r"(\w+)(?:\[\d+\])?\s*$", part)[0]
                for d in decls if d.strip() for part in d.split(",")]

    assert fields("LmvnFft") == [f[0] for f in fu._FftArgs._fields_] == [
        "n", "nstages", "radix", "tw", "pos"]
    assert fields("LmvnAxis") == [f[0] for f in fu._AxisArgs._fields_] == [
        "f", "kind", "m", "chirp", "bhat", "part"]
    assert ctypes.sizeof(fu._FftArgs) == 88
    assert (fu._FftArgs.radix.offset, fu._FftArgs.tw.offset, fu._FftArgs.pos.offset) == (8, 72, 80)
    assert ctypes.sizeof(fu._AxisArgs) == 128
    assert (fu._AxisArgs.kind.offset, fu._AxisArgs.m.offset, fu._AxisArgs.chirp.offset,
            fu._AxisArgs.bhat.offset, fu._AxisArgs.part.offset) == (88, 92, 96, 104, 112)
    assert fu._PlanArgs.Mz.offset == 32
    assert (fu._PlanArgs.fx.offset, fu._PlanArgs.fy.offset, fu._PlanArgs.fz.offset) == (40, 168, 296)
    assert ctypes.sizeof(fu._PlanArgs) == 424
    assert "constexpr int kDirect = 0, kFourStep = 1, kBluestein = 2;" in header
    assert fp.KINDS == ("direct", "four_step", "bluestein")
    assert f"constexpr int kMaxLength = 1 << {fp.MAX_LENGTH.bit_length() - 1};" in header
    long_header = (Path(fu.__file__).parent / "csrc" / "fft_long.cuh").read_text()
    assert f"constexpr int kYLongRows = {fu._Y_LONG_ROWS};" in long_header
