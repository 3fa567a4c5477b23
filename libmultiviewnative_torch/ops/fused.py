"""The fused RL-step engine: its seven passes, the view steps, the
standalone convolve and the kernel-spectrum forwarding.

Counterpart of ``libmultiviewnative_tpu/ops/pallas/fused_dft2.py`` in its
dense packed x-mode with twiddle-folded split stages, at fp32 (the JAX
``precision="highest"`` contract).  One view step on (Z, X, Y)-transposed
volumes is five passes:

    A(psi) -> B(x K1) -> CQA (C of conv1, quotient, A of conv2) -> B(x K2) -> CU

or four in the carried chain, where pass A of psi travels from one step to
the next (:func:`fused_rl_step_carried`):

    B(x K1) -> CQA -> B(x K2) -> CUA (CU, then A of psi')

* K4 :func:`pass_a` replaces ``_run_pass_a`` (``fused_dft2.py:1703``): x-rfft
  then y-DFT, (Z, X, Y) -> u (Kxp, Z, Y) re/im.  On the card, two
  shared-memory FFT stages (``ops/csrc/fft_stage.cuh``).
* K5 :func:`pass_bf` replaces ``_run_pass_bf`` (:1764): the split z-DFT
  alone, which forwards a kernel spectrum (:func:`kernel_spectrum_fused`).
  On the card, one shared-memory FFT z stage (``ops/csrc/fft_stage.cuh``).
* K6 :func:`pass_b` replaces ``_run_pass_b`` (:1735): split z-DFT, times the
  kernel spectrum (or its conjugate, ``conj_k``), split z-inverse.  On the
  card, the same z stage with the product and the inverse FFT in it.
* K7 :func:`pass_c` replaces ``_run_pass_c`` (:1825): y-inverse and x-irfft,
  u -> the real (Z, X, Y) volume (:func:`fused_convolve_transposed` is A, B,
  C).  On the card, the two FFT stages of K4 run backwards.
* K8 :func:`pass_cqa` replaces ``_run_pass_cqa`` (:1854): y-inverse, x-irfft,
  view · (1/blurred), x-rfft, y-DFT; the quotient volume is never stored.
  On the card, K7's y stage, one x stage that holds the inverse x FFT, K2's
  quotient and the forward x FFT in shared memory, and K4's y stage.
* K9 :func:`pass_cu` replaces ``_run_pass_cu`` (:1909): y-inverse, x-irfft
  and the RL update of K1; the integral volume is never stored.  On the
  card, K7's two stages with K1's update in place of K7's store, so K9 is
  K1 of K7's output bit for bit.
* K10 :func:`pass_cua` replaces ``_run_pass_cua`` (:1950): K9, then pass A
  of psi'.  On the card, K8's three launches with K1's update in place of
  the quotient: psi' is stored and kept in shared memory for the forward x
  FFT.

Spectra are split (re, im) pairs shaped (Kxp, Z, Y), with z and y in the
interleaved order of :func:`.fused_plan.split_perm` and the pad rows k in
[Kx, Kxp) zero.  The kernels are the FFT stages of
``ops/csrc/fft_stage.cuh``, launched from the entries of ``ops/csrc/fused.cu``.
An axis no shared-memory stage holds (past 14528, or with a prime factor
over 1024; up to 2^25) runs its stage as a four-step or Bluestein transform
through a work buffer in HBM (``ops/csrc/fft_long.cuh``), inside the same
pass call: :func:`_work` allocates it, about one scratch pair.

Storage (:func:`spec_dtype`, the JAX package's ``LMVN_FUSED_SPEC_BF16``,
``fused_dft2.py:530-550``): spectra are stored as float32, or as bfloat16
with ``LMVN_FUSED_SPEC_BF16=1``.  Compute is float32 either way: a pass widens
the spectra it reads and rounds the spectrum it writes once, to nearest
even, as JAX's ``_ld`` and ``astype`` do; the scratch pair between a pass's
stages and every real volume stay float32.  A pass reads either dtype, so
spectra made under the other setting mix in as they do in JAX.  On the card,
a pass whose spectra are all bf16 launches its entry's ``_bf16`` twin
(counted under ``<pass>_bf16`` in :data:`launches`); any other mix widens
its bf16 inputs and launches the f32 entry, and rounds what it writes where
the storage is bf16.

Dispatch, as in :mod:`.elementwise`: a CPU tensor runs the plain PyTorch
version (``pass_*_plain``, ``torch.matmul`` over whole tensors), a CUDA
tensor launches the kernel or raises.  Each pass call on the card adds one to
:data:`launches`; a pass call is 2 (A, C, CU), 1 (BF, B) or 3 (CQA, CUA)
CUDA launches.  All but BF and B write one scratch spectrum pair from
``torch.empty``.  The plain versions are the JAX package's matrix-product
stages; the FFT stages compute the same transforms.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.kernels import compute_quotient, rl_update as rl_update_plain
from ..core.wrap import wrap_kernel
from . import _build
from ..utils.precision import fp32_matmuls as _fp32_matmuls
from ..utils.trace import check_kernel_output, spanned
from .elementwise import _check, _device, _stream, _wants_grad
from .fused_plan import (
    FFT_MAX_STAGES, KINDS, MAX_LENGTH, FftStages, FusedPlan, make_fft_stages, make_fused_plan,
    split_perm,
)

Pair = Tuple[torch.Tensor, torch.Tensor]

PASSES = ("pass_a", "pass_bf", "pass_b", "pass_c", "pass_cqa", "pass_cu", "pass_cua")
# launch counts of the seven passes and of their bf16 twins ("pass_a_bf16",
# ...); a plain-version call never counts
launches = {name + sfx: 0 for sfx in ("", "_bf16") for name in PASSES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_SPEC_DTYPES = (torch.float32, torch.bfloat16)


def spec_dtype() -> torch.dtype:
    """The storage dtype of the fused spectra: ``torch.bfloat16`` when
    ``LMVN_FUSED_SPEC_BF16`` is ``1``; unset (the JAX default ``"0"``) or any
    other value, ``torch.float32`` (``fused_dft2.py:530-545``).  Read by each
    pass, as JAX's passes read ``_spec_dtype()``.  bf16 storage is opt-in
    and outside the fp32 contract: it rounds every spectrum to 8 significant
    bits where a pass stores it."""
    if os.environ.get("LMVN_FUSED_SPEC_BF16", "0") == "1":
        return torch.bfloat16
    return torch.float32


# The opt-in maximum of one block's shared memory, in bytes, and the tile
# rules of the FFT stages: kSmemMax, kMinTile, kXSeqMax, kYRowsMax,
# kYSmemTarget and kZColsMax in ops/csrc/fft_stage.cuh, where plan_ok
# (ops/csrc/fused.cu) holds every direct length to them.
_FFT_SMEM_MAX = 232448
_MIN_TILE = 2
_Y_SMEM_TARGET = 64 * 1024
# rows of the y stage a group of the long stages' work buffer interleaves
# (kYLongRows in ops/csrc/fft_long.cuh)
_Y_LONG_ROWS = 16
_CARD_REFUSED = (
    "the CUDA passes serve every axis that is a multiple of 8 up to 2^25 = 33554432"
    " (the JAX package's dense x plan there, two X×X float32 matrices, would need over 9 PB)"
)


def _widest_tile(widest: int, n: int) -> int:
    """``widest_tile``: the widest tile of P length-n complex sequences, P
    halving from ``widest`` to 2, that fits one block's shared memory; 0
    if none does."""
    p = widest
    while p >= _MIN_TILE:
        if 8 * p * n <= _FFT_SMEM_MAX:
            return p
        p //= 2
    return 0


def _x_seq(X: int) -> int:
    """Sequences (column pairs) a block of the FFT x stage holds, every pass
    but B and BF (``x_seq``): 16 up to X = 1816, 8 to 3632, 4 to 7264, 2 to
    14528, else 0."""
    return _widest_tile(16, X)


def _y_rows(Y: int) -> int:
    """Rows a block of the FFT y stage holds, every pass but B and BF
    (``y_rows``): 16 up to Y = 512, then 8 to 3632, 4 to 7264, 2 to 14528,
    else 0."""
    return 16 if 16 * 8 * Y <= _Y_SMEM_TARGET else _widest_tile(8, Y)


def _z_cols(Z: int) -> int:
    """Columns a block of the FFT z stage holds, passes B and BF
    (``z_cols``): 16 up to Z = 1816, 8 to 3632, 4 to 7264, 2 to 14528,
    else 0."""
    return _widest_tile(16, Z)


def _largest_prime_factor(n: int) -> int:
    largest, p = 1, 2
    while p * p <= n:
        while n % p == 0:
            largest, n = p, n // p
        p += 1
    return max(largest, n)


def fused_limit(shape: Sequence[int], device=None) -> Optional[str]:
    """Why the fused engine cannot serve a (Z, X, Y) transposed volume on
    ``device``, or None when it can.

    Every device: every axis a multiple of 8 (so X is even), as
    ``fused_dft2._check_transposed``.  A CUDA device adds the kernels' limit
    (``plan_ok`` in ``ops/csrc/fused.cu``), which holds for every pass,
    since one plan serves them all: each axis at most 2^25
    (:data:`.fused_plan.MAX_LENGTH`).  Every length up to there has a plan
    (:func:`.fused_plan.plan_kind`):

    * direct, up to 14528 with every prime factor at most 1024: the
      shared-memory stages, their tiles narrowing with the length (x
      :func:`_x_seq` and z :func:`_z_cols` sequences 16 up to 1816, y
      :func:`_y_rows` rows 16 up to 512, each down to 2 at 14528);
    * four-step, past that where the length splits into two direct ones
      (14536 = 92·158, 16384 = 128·128);
    * Bluestein, the rest (8248 = 8·1031, 116152 = 8·14519), padded to a
      power of two: 2^26 = 8192·8192 at 2^25, the longest whose four-step
      factors are direct, hence the limit."""
    Z, X, Y = (int(s) for s in shape)
    if Z % 8 or X % 8 or Y % 8:
        return f"the fused engine requires Z/Y/X multiples of 8; got ZXY={(Z, X, Y)}"
    if device is None or torch.device(device).type != "cuda":
        return None
    for axis, n in (("X", X), ("Y", Y), ("Z", Z)):
        if n > MAX_LENGTH:
            return (f"{axis}={n} is past 2^25 = {MAX_LENGTH}: a Bluestein transform there pads"
                    " past 2^26 = 8192², the longest four-step of two shared-memory FFT lengths")
    return None


def check_transposed_shape(shape: Sequence[int], device=None) -> Tuple[int, int, int]:
    """(Z, X, Y) of a transposed volume the engine can serve on ``device``
    (:func:`fused_limit`).  Raises ValueError for a shape the engine cannot
    serve anywhere, NotImplementedError for one the CUDA passes cannot
    serve (an axis past 2^25)."""
    if len(shape) != 3:
        raise ValueError("the fused engine operates on single volumes")
    Z, X, Y = (int(s) for s in shape)
    why = fused_limit((Z, X, Y))
    if why:
        raise ValueError(why)
    why = fused_limit((Z, X, Y), device)
    if why:
        raise NotImplementedError(f"fused engine on the card, ZXY={(Z, X, Y)}: {why}; {_CARD_REFUSED}")
    return Z, X, Y


# ---------------------------------------------------------------- constants


class _FftArgs(ctypes.Structure):
    """``LmvnFft`` of ``ops/csrc/fft_stage.cuh``: one length's FFT stages
    (a direct :func:`.fused_plan.make_fft_stages` plan)."""

    _fields_ = [
        ("n", ctypes.c_int), ("nstages", ctypes.c_int), ("radix", ctypes.c_int * FFT_MAX_STAGES),
        ("tw", ctypes.c_void_p), ("pos", ctypes.c_void_p),
    ]


class _AxisArgs(ctypes.Structure):
    """``LmvnAxis`` of ``ops/csrc/fft_stage.cuh``: one axis's FFT plan, its
    kind an index of :data:`.fused_plan.KINDS`; ``part`` points at the plans
    a four-step or Bluestein plan runs."""


_AxisArgs._fields_ = [
    ("f", _FftArgs), ("kind", ctypes.c_int), ("m", ctypes.c_int), ("chirp", ctypes.c_void_p),
    ("bhat", ctypes.c_void_p), ("part", ctypes.POINTER(_AxisArgs) * 2),
]


class _PlanArgs(ctypes.Structure):
    """``LmvnFusedPlan`` of ``ops/csrc/fused.cu``, field by field."""

    _fields_ = [
        (n, ctypes.c_int) for n in ("Z", "X", "Y", "Kx", "Kxp", "Ry", "My", "Rz", "Mz")
    ] + [("fx", _AxisArgs), ("fy", _AxisArgs), ("fz", _AxisArgs)]


class PlanTensors:
    """A plan's tables on one device.  For a CUDA device, the FFT stage
    tables of its x, y and z lengths and the kernels' argument struct
    pointing at them, made here; the plan's dense matrices, which only the
    plain passes read, as float32 tensors uploaded on first use.  Every
    launch reads a plan through this class, so this is where a shape
    outside the CUDA passes' limits (:func:`fused_limit`) raises."""

    def __init__(self, plan: FusedPlan, device: torch.device):
        Z, Y, X = plan.shape
        check_transposed_shape((Z, X, Y), device)
        self.plan, self.device = plan, device
        self.args = None
        if device.type != "cuda":
            return
        self.keep = []  # the tables and part structs the argument struct points at
        axes = [self._axis_args(make_fft_stages(n)) for n in (X, Y, Z)]
        self.args = _PlanArgs(Z, X, Y, plan.kxh, plan.kxp, *plan.split_y, *plan.split_z, *axes)

    def _axis_args(self, st: FftStages) -> _AxisArgs:
        """The ``LmvnAxis`` of one plan, its tables uploaded and kept."""
        def table(values):
            if values is None or not len(values):
                return None
            t = self._upload(np.stack([values.real, values.imag], axis=-1))
            self.keep.append(t)
            return t.data_ptr()

        pos = None
        if len(st.pos):
            self.keep.append(torch.as_tensor(st.pos, device=self.device))
            pos = self.keep[-1].data_ptr()
        parts = [self._axis_args(p) for p in st.parts]
        self.keep.extend(parts)
        part = (ctypes.POINTER(_AxisArgs) * 2)(*map(ctypes.pointer, parts))
        radix = (ctypes.c_int * FFT_MAX_STAGES)(*st.radices)
        f = _FftArgs(st.n, len(st.radices), radix, table(st.tw), pos)
        return _AxisArgs(f, KINDS.index(st.kind), st.m, table(st.chirp), table(st.bhat), part)

    def _upload(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).contiguous()

    @functools.cached_property
    def fxp(self) -> torch.Tensor:
        return self._upload(self.plan.fxp)

    @functools.cached_property
    def bxp(self) -> torch.Tensor:
        return self._upload(self.plan.bxp)

    @functools.cached_property
    def wfy(self) -> Tuple[torch.Tensor, ...]:
        return tuple(map(self._upload, self.plan.sy.wf))

    @functools.cached_property
    def wiy(self) -> Tuple[torch.Tensor, ...]:
        return tuple(map(self._upload, self.plan.sy.wi))

    @functools.cached_property
    def wfz(self) -> Tuple[torch.Tensor, ...]:
        return tuple(map(self._upload, self.plan.sz.wf))

    @functools.cached_property
    def wiz(self) -> Tuple[torch.Tensor, ...]:
        return tuple(map(self._upload, self.plan.sz.wi))


_tensors = {}


def plan_tensors(plan: FusedPlan, device) -> PlanTensors:
    """The cached :class:`PlanTensors` of ``plan`` on ``device``."""
    device = torch.device(device)
    key = (plan.shape, str(device))
    got = _tensors.get(key)
    if got is None or got.plan is not plan:
        got = _tensors[key] = PlanTensors(plan, device)
    return got


# ---------------------------------------------------------------- plain passes
# The JAX package's split-stage helpers (fused_dft2.py:606-800, 949-983) on
# whole tensors: "right" stages contract the last axis (y), "left" stages
# the second to last (z).


def _scalar_cmul(s, re, im):
    """complex scalar · complex block, with the ±1/0 fast paths."""
    a, b = float(s.real), float(s.imag)
    if b == 0.0:
        if a == 1.0:
            return re, im
        return a * re, a * im
    if a == 0.0:
        return -b * im, b * re
    return a * re - b * im, b * re + a * im


def _cmul(d_re, d_im, trip, right: bool):
    """(d_re + i d_im) @ (A + iB) (right) or (A + iB) @ (d_re + i d_im)
    (left) in the 3-product Karatsuba form; trip = (A, B, A+B)."""
    a, b, ab = trip
    mm = (lambda x, w: torch.matmul(x, w)) if right else (lambda x, w: torch.matmul(w, x))
    m1 = mm(d_re, a)
    m2 = mm(d_im, b)
    m3 = mm(d_re + d_im, ab)
    return m1 - m2, m3 - m1 - m2


def _q_trip(trip, q: int, M: int):
    """The per-q stage matrices of a folded (R·M, M) triple."""
    return tuple(w[q * M : (q + 1) * M] for w in trip)


def _blocks(x, R: int, dim: int):
    return list(torch.chunk(x, R, dim=dim))


def _fwd_split(b_re, b_im, trip, om, right: bool):
    """R input blocks -> R output blocks; block q holds frequencies R·p+q."""
    R, M = om.shape[0], trip[0].shape[1]
    out_re, out_im = [], []
    for q in range(R):
        yr = yi = None
        for r in range(R):
            tr, ti = _scalar_cmul(om[q, r], b_re[r], b_im[r])
            yr = tr if yr is None else yr + tr
            yi = ti if yi is None else yi + ti
        ur, ui = _cmul(yr, yi, _q_trip(trip, q, M), right)
        out_re.append(ur)
        out_im.append(ui)
    return out_re, out_im


def _inv_split(b_re, b_im, trip, om, right: bool):
    """R frequency blocks (interleaved order) -> R spatial blocks."""
    R, M = om.shape[0], trip[0].shape[1]
    acc_re, acc_im = [None] * R, [None] * R
    for q in range(R):
        zr, zi = _cmul(b_re[q], b_im[q], _q_trip(trip, q, M), right)
        for r in range(R):
            tr, ti = _scalar_cmul(om[q, r], zr, zi)
            acc_re[r] = tr if acc_re[r] is None else acc_re[r] + tr
            acc_im[r] = ti if acc_im[r] is None else acc_im[r] + ti
    return acc_re, acc_im


def _zero_pad_rows(u_re, u_im, kx: int):
    u_re[kx:] = 0.0
    u_im[kx:] = 0.0
    return u_re, u_im


def _stored(pair: Pair, spec: torch.dtype) -> Pair:
    """A spectrum computed in float32, in the storage dtype (rounded to
    nearest even for bf16, as JAX's ``astype``)."""
    return tuple(t.to(spec) for t in pair)


def _widened(*ts):
    """The spectra a plain pass computes on: bf16 widened to float32, other
    dtypes as they are (float32; float64 where a caller evaluates a plain
    pass wider, with the plan's constants widened too)."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


def pass_a_plain(xt: torch.Tensor, c: PlanTensors, spec=torch.float32) -> Pair:
    """Plain K4: t = fxp @ plane for every plane, then the split y-DFT;
    stored as ``spec``."""
    plan, R = c.plan, c.plan.sy.R
    kxp = plan.kxp
    t = torch.matmul(c.fxp, xt)  # (Z, 2Kxp, Y)
    o_re, o_im = _fwd_split(
        _blocks(t[:, :kxp], R, -1), _blocks(t[:, kxp:], R, -1), c.wfy, plan.sy.omf, True
    )
    u_re = torch.cat(o_re, dim=-1).transpose(0, 1).contiguous()
    u_im = torch.cat(o_im, dim=-1).transpose(0, 1).contiguous()
    return _stored(_zero_pad_rows(u_re, u_im, plan.kxh), spec)


def pass_b_plain(u_re, u_im, k_re, k_im, c: PlanTensors, conj_k: bool = False,
                 spec=torch.float32) -> Pair:
    """Plain K6: split z-DFT, × K̂ (or conj K̂), split z-inverse, per slice,
    on the widened spectra; stored as ``spec``."""
    plan, R = c.plan, c.plan.sz.R
    u_re, u_im, k_re, k_im = _widened(u_re, u_im, k_re, k_im)
    v_re, v_im = _fwd_split(_blocks(u_re, R, 1), _blocks(u_im, R, 1), c.wfz, plan.sz.omf, False)
    kr, ki = _blocks(k_re, R, 1), _blocks(-k_im if conj_k else k_im, R, 1)
    p_re = [v_re[q] * kr[q] - v_im[q] * ki[q] for q in range(R)]
    p_im = [v_re[q] * ki[q] + v_im[q] * kr[q] for q in range(R)]
    w_re, w_im = _inv_split(p_re, p_im, c.wiz, plan.sz.omi, False)
    return _stored(_zero_pad_rows(torch.cat(w_re, dim=1), torch.cat(w_im, dim=1), plan.kxh), spec)


def pass_bf_plain(u_re, u_im, c: PlanTensors, spec=torch.float32) -> Pair:
    """Plain K5: the split z-DFT of pass B alone, per x-frequency slice, on
    the widened spectrum; stored as ``spec``."""
    plan, R = c.plan, c.plan.sz.R
    u_re, u_im = _widened(u_re, u_im)
    v_re, v_im = _fwd_split(_blocks(u_re, R, 1), _blocks(u_im, R, 1), c.wfz, plan.sz.omf, False)
    return _stored(_zero_pad_rows(torch.cat(v_re, dim=1), torch.cat(v_im, dim=1), plan.kxh), spec)


def pass_c_plain(v_re, v_im, c: PlanTensors) -> torch.Tensor:
    """Plain K7: split y-inverse and packed x-irfft, (Kxp, Z, Y) -> (Z, X, Y),
    on the widened spectrum.  Also the C half of K8, K9 and K10."""
    plan, R = c.plan, c.plan.sy.R
    v_re, v_im = _widened(v_re, v_im)
    t_re, t_im = _inv_split(
        _blocks(v_re.transpose(0, 1), R, -1), _blocks(v_im.transpose(0, 1), R, -1),
        c.wiy, plan.sy.omi, True,
    )
    return torch.cat(
        [torch.matmul(c.bxp, torch.cat([t_re[r], t_im[r]], dim=-2)) for r in range(R)], dim=-1
    )


def pass_cqa_plain(v_re, v_im, view_t, c: PlanTensors, spec=torch.float32) -> Pair:
    """Plain K8: pass A of view · (1/blurred), blurred = pass C of v; the
    quotient stays float32, the spectrum is stored as ``spec``."""
    return pass_a_plain(compute_quotient(view_t, pass_c_plain(v_re, v_im, c)), c, spec)


def pass_cu_plain(v_re, v_im, psi_t, weights, c: PlanTensors, lam, min_value) -> torch.Tensor:
    """Plain K9: the RL update of K1 with the integral pass C of v."""
    return rl_update_plain(psi_t, pass_c_plain(v_re, v_im, c), weights, lam, min_value)


def pass_cua_plain(v_re, v_im, psi_t, weights, c: PlanTensors, lam, min_value,
                   spec=torch.float32):
    """Plain K10: plain K9, then plain K4 of its psi'; (psi', (u_re, u_im)),
    the spectrum stored as ``spec``."""
    new = pass_cu_plain(v_re, v_im, psi_t, weights, c, lam, min_value)
    return new, pass_a_plain(new, c, spec)


# ---------------------------------------------------------------- wrappers


def _plan_for(xt_shape, plan: Optional[FusedPlan], device=None) -> FusedPlan:
    """``plan``, or a new plan for a (Z, X, Y) volume; a shape ``device``
    cannot serve raises first."""
    Z, X, Y = check_transposed_shape(xt_shape, device)
    if plan is None:
        return make_fused_plan((Z, Y, X))
    if tuple(plan.shape) != (Z, Y, X):
        raise ValueError(f"plan is for (Z, Y, X)={plan.shape}, the volume is ZXY={(Z, X, Y)}")
    return plan


def _check_f32(name, t, shape, dtype=torch.float32):
    _check(name, t, dtype, shape)
    if t.is_neg():
        raise ValueError(f"{name} is a lazy negative view; call resolve_neg() first")


def _spec_shape(plan: FusedPlan):
    Z, Y, _ = plan.shape
    return (plan.kxp, Z, Y)


def _check_pair(name, pair, plan, dtype=None):
    """An (re, im) spectrum pair: float32 or bfloat16 (``dtype`` when
    given), both parts alike."""
    if len(pair) != 2:
        raise ValueError(f"{name} must be an (re, im) pair")
    dtype = dtype or getattr(pair[0], "dtype", None)
    if dtype not in _SPEC_DTYPES:
        raise TypeError(f"{name} must be a float32 or bfloat16 pair, got {dtype}")
    for part, t in zip(("re", "im"), pair):
        _check_f32(f"{name}_{part}", t, _spec_shape(plan), dtype)


def _outputs(out, plan, like, dtype):
    """``out``, or a new spectrum pair of ``dtype`` on ``like``'s device."""
    if out is not None:
        return out
    return tuple(torch.empty(_spec_shape(plan), dtype=dtype, device=like.device) for _ in "ri")


def _scratch(plan, like) -> Pair:
    """The scratch pair t that carries values between a pass's stages:
    float32 whatever the storage, as the values stay f32 in VMEM between a
    JAX pass's stages."""
    return _outputs(None, plan, like, torch.float32)


@functools.lru_cache(maxsize=256)
def _work_values(shape: Tuple[int, int, int], axes: str) -> int:
    """The work buffer (complex values) the long stages among ``axes`` ("x",
    "y", "z") of a pass at plan shape (Z, Y, X) need, the largest of them
    (``x_work``, ``y_work``, ``z_work`` of ``ops/csrc/fft_long.cuh``); 0
    where none is long."""
    Z, Y, X = shape
    kx = X // 2 + 1
    need = {"x": (X, Z * (Y // 2)), "z": (Z, kx * Y),
            "y": (Y, -(-kx * Z // _Y_LONG_ROWS) * _Y_LONG_ROWS)}
    values = [0]
    for axis in axes:
        n, sequences = need[axis]
        st = make_fft_stages(n)
        if st.kind != "direct":
            values.append(sequences * (st.m if st.kind == "bluestein" else n))
    return max(values)


def _work(plan: FusedPlan, dev: torch.device, axes: str):
    """(buffer, values) of a new work buffer on ``dev`` for the long stages
    among ``axes`` of a pass, or (None, 0) where every stage is direct."""
    values = _work_values(tuple(plan.shape), axes)
    if not values:
        return None, 0
    return torch.empty(2 * values, dtype=torch.float32, device=dev), values


def _kind(spec: torch.dtype, inputs) -> torch.dtype:
    """The storage a CUDA pass that writes a spectrum launches with: bf16
    (its ``_bf16`` twin) where every spectrum it reads is bf16 and the
    storage dtype ``spec`` is bf16 too; else float32."""
    dtypes = {t.dtype for t in inputs} | {spec}
    return torch.bfloat16 if dtypes == {torch.bfloat16} else torch.float32


def _store(res: Pair, spec: torch.dtype, out: Optional[Pair]) -> Pair:
    """A spectrum a launch wrote, in the storage dtype: ``res`` itself (which
    is ``out`` when given), or, after a float32 launch under bf16 storage,
    rounded once to nearest even, into ``out`` when given."""
    if res[0].dtype == spec:
        return res
    if out is None:
        return _stored(res, spec)
    for o, r in zip(out, res):
        o.copy_(r)
    return out


# the axes whose stages each pass runs
_AXES = {"pass_a": "xy", "pass_bf": "z", "pass_b": "z", "pass_c": "xy", "pass_cqa": "xy",
         "pass_cu": "xy", "pass_cua": "xy"}


def _launch(name: str, kind: torch.dtype, dev: torch.device, c: PlanTensors, *args) -> None:
    """Launch pass ``name``'s entry for ``kind`` spectra (``lmvn_fused_<name>``
    or its ``_bf16`` twin) on the current stream, with a work buffer where a
    stage of the pass is long, and count it."""
    entry = name if kind == torch.float32 else f"{name}_bf16"
    work, values = _work(c.plan, dev, _AXES[name])
    err = getattr(_build.library(), f"lmvn_fused_{entry}")(
        dev.index, ctypes.addressof(c.args), *args, _ptr(work), values, _stream(dev))
    _build.check(entry, err)
    launches[entry] += 1


def _finish(out, res):
    """``res``, or ``out`` with ``res`` copied in (the CPU path's ``out=``)."""
    if out is None:
        return res
    if isinstance(res, tuple):
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    return out.copy_(res)


def _no_graph(name, *operands):
    """The CUDA passes write through raw pointers, so autograd would see no
    graph: refuse instead of returning detached values.  (On the CPU the
    plain passes are PyTorch ops, differentiable without ``out=``.)"""
    if _wants_grad(*operands):
        raise NotImplementedError(f"{name}: the CUDA pass has no backward yet (ROADMAP P16)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_aligned(**tensors):
    """The FFT stages move 8- and 16-byte vectors: every tensor they read or
    write starts on a 16-byte boundary (a fresh allocation does)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the CUDA pass")


@spanned("lmvn.engine.pass_a")
def pass_a(xt: torch.Tensor, plan: Optional[FusedPlan] = None, out: Optional[Pair] = None) -> Pair:
    """K4: (Z, X, Y) volume -> its (Kxp, Z, Y) re/im pass-A spectrum, stored
    as :func:`spec_dtype`."""
    plan, spec = _plan_for(xt.shape, plan, xt.device), spec_dtype()
    _check_f32("xt", xt, None)
    if out is not None:
        _check_pair("out", out, plan, spec)
    dev = _device(xt, *(out or ()))
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return _finish(out, pass_a_plain(xt, c, spec))
    _no_graph("pass_a", xt)
    u = _outputs(out, plan, xt, spec)
    t = _scratch(plan, xt)
    _check_aligned(xt=xt, out_re=u[0], out_im=u[1])
    _launch("pass_a", spec, dev, c, *map(_ptr, u), *map(_ptr, t), _ptr(xt))
    check_kernel_output("pass_a", *u)
    return u


@spanned("lmvn.engine.pass_b")
def pass_b(
    u_re, u_im, k_re, k_im, plan: FusedPlan, conj_k: bool = False, out: Optional[Pair] = None,
) -> Pair:
    """K6: z-DFT · K̂ (or conj K̂ with ``conj_k``) · z-inverse on a (Kxp, Z, Y)
    pair, stored as :func:`spec_dtype`; ``out`` may be ``(u_re, u_im)``."""
    spec = spec_dtype()
    _check_pair("u", (u_re, u_im), plan)
    _check_pair("k", (k_re, k_im), plan)
    if out is not None:
        _check_pair("out", out, plan, spec)
    dev = _device(u_re, u_im, k_re, k_im, *(out or ()))
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return _finish(out, pass_b_plain(u_re, u_im, k_re, k_im, c, conj_k, spec))
    _no_graph("pass_b", u_re, u_im, k_re, k_im)
    kind = _kind(spec, (u_re, k_re))
    u_re, u_im, k_re, k_im = (x.to(kind) for x in (u_re, u_im, k_re, k_im))
    o = _outputs(out if kind == spec else None, plan, u_re, kind)
    _check_aligned(u_re=u_re, u_im=u_im, k_re=k_re, k_im=k_im, out_re=o[0], out_im=o[1])
    _launch("pass_b", kind, dev, c, *map(_ptr, o), _ptr(u_re), _ptr(u_im),
            _ptr(k_re), _ptr(k_im), int(bool(conj_k)))
    check_kernel_output("pass_b", *o)
    return _store(o, spec, out)


@spanned("lmvn.engine.pass_bf")
def pass_bf(u_re, u_im, plan: FusedPlan) -> Pair:
    """K5: the split z-DFT of a (Kxp, Z, Y) pair into a new pair, stored as
    :func:`spec_dtype`."""
    spec = spec_dtype()
    _check_pair("u", (u_re, u_im), plan)
    dev = _device(u_re, u_im)
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return pass_bf_plain(u_re, u_im, c, spec)
    _no_graph("pass_bf", u_re, u_im)
    kind = _kind(spec, (u_re,))
    u_re, u_im = u_re.to(kind), u_im.to(kind)
    o = _outputs(None, plan, u_re, kind)
    _check_aligned(u_re=u_re, u_im=u_im)
    _launch("pass_bf", kind, dev, c, *map(_ptr, o), _ptr(u_re), _ptr(u_im))
    check_kernel_output("pass_bf", *o)
    return _store(o, spec, None)


@spanned("lmvn.engine.pass_c")
def pass_c(v_re, v_im, plan: FusedPlan) -> torch.Tensor:
    """K7: split y-inverse and packed x-irfft of a (Kxp, Z, Y) pair (float32
    or bf16), the real (Z, X, Y) volume."""
    _check_pair("v", (v_re, v_im), plan)
    Z, Y, X = plan.shape
    dev = _device(v_re, v_im)
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return pass_c_plain(v_re, v_im, c)
    _no_graph("pass_c", v_re, v_im)
    _check_aligned(v_re=v_re, v_im=v_im)
    out = torch.empty((Z, X, Y), device=v_re.device)
    t = _scratch(plan, v_re)
    _launch("pass_c", v_re.dtype, dev, c, _ptr(out), *map(_ptr, t),
            _ptr(v_re), _ptr(v_im))
    check_kernel_output("pass_c", out)
    return out


@spanned("lmvn.engine.pass_cqa")
def pass_cqa(v_re, v_im, view_t, plan: FusedPlan, out: Optional[Pair] = None) -> Pair:
    """K8: pass A of view · (1/blurred), blurred = pass C of v, stored as
    :func:`spec_dtype`; ``out`` may be ``(v_re, v_im)``."""
    spec = spec_dtype()
    _check_pair("v", (v_re, v_im), plan)
    Z, Y, X = plan.shape
    _check_f32("view_t", view_t, (Z, X, Y))
    if out is not None:
        _check_pair("out", out, plan, spec)
    dev = _device(v_re, v_im, view_t, *(out or ()))
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return _finish(out, pass_cqa_plain(v_re, v_im, view_t, c, spec))
    _no_graph("pass_cqa", v_re, v_im, view_t)
    kind = _kind(spec, (v_re,))
    v_re, v_im = v_re.to(kind), v_im.to(kind)
    u = _outputs(out if kind == spec else None, plan, v_re, kind)
    _check_aligned(v_re=v_re, v_im=v_im, view_t=view_t, out_re=u[0], out_im=u[1])
    t = _scratch(plan, v_re)
    _launch("pass_cqa", kind, dev, c, *map(_ptr, u), *map(_ptr, t),
            _ptr(v_re), _ptr(v_im), _ptr(view_t))
    check_kernel_output("pass_cqa", *u)
    return _store(u, spec, out)


@spanned("lmvn.engine.pass_cu")
def pass_cu(
    v_re, v_im, psi_t, weights, plan: FusedPlan, lam, min_value: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K9: the RL update of psi with the integral pass C of v (float32 or
    bf16).  ``weights`` is a (Z, X, Y) tensor or a scalar; ``out`` may be
    ``psi_t``."""
    _check_pair("v", (v_re, v_im), plan)
    Z, Y, X = plan.shape
    _check_f32("psi_t", psi_t, (Z, X, Y))
    per_voxel = isinstance(weights, torch.Tensor) and weights.ndim > 0
    operands = [v_re, v_im, psi_t]
    if per_voxel:
        _check_f32("weights", weights, (Z, X, Y))
        operands.append(weights)
    if out is not None:
        _check_f32("out", out, (Z, X, Y))
        operands.append(out)
    dev = _device(*operands)
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        return _finish(out, pass_cu_plain(v_re, v_im, psi_t, weights, c, lam, min_value))
    _no_graph("pass_cu", *operands)
    if out is None:
        out = torch.empty_like(psi_t)
    _check_aligned(v_re=v_re, v_im=v_im, psi_t=psi_t, out=out,
                   **({"weights": weights} if per_voxel else {}))
    t = _scratch(plan, v_re)
    _launch("pass_cu", v_re.dtype, dev, c, _ptr(out), *map(_ptr, t),
            _ptr(v_re), _ptr(v_im), _ptr(psi_t), _ptr(weights) if per_voxel else None,
            0.0 if per_voxel else float(weights), float(lam), float(min_value))
    check_kernel_output("pass_cu", out)
    return out


@spanned("lmvn.engine.pass_cua")
def pass_cua(
    v_re, v_im, psi_t, weights, plan: FusedPlan, lam, min_value: float,
    out: Optional[torch.Tensor] = None, u_out: Optional[Pair] = None,
) -> Tuple[torch.Tensor, Pair]:
    """K10: pass CU, then pass A of its psi' (the next view step's first
    pass): (psi', (u_re, u_im)), the spectrum stored as :func:`spec_dtype`.
    ``out`` may be ``psi_t``, ``u_out`` may be ``(v_re, v_im)``."""
    spec = spec_dtype()
    _check_pair("v", (v_re, v_im), plan)
    Z, Y, X = plan.shape
    _check_f32("psi_t", psi_t, (Z, X, Y))
    per_voxel = isinstance(weights, torch.Tensor) and weights.ndim > 0
    operands = [v_re, v_im, psi_t, *(u_out or ())]
    if per_voxel:
        _check_f32("weights", weights, (Z, X, Y))
        operands.append(weights)
    if out is not None:
        _check_f32("out", out, (Z, X, Y))
        operands.append(out)
    if u_out is not None:
        _check_pair("u_out", u_out, plan, spec)
    dev = _device(*operands)
    c = plan_tensors(plan, dev)
    if dev.type == "cpu":
        new, u = pass_cua_plain(v_re, v_im, psi_t, weights, c, lam, min_value, spec)
        return _finish(out, new), _finish(u_out, u)
    _no_graph("pass_cua", *operands)
    if out is None:
        out = torch.empty_like(psi_t)
    kind = _kind(spec, (v_re,))
    v_re, v_im = v_re.to(kind), v_im.to(kind)
    u = _outputs(u_out if kind == spec else None, plan, v_re, kind)
    _check_aligned(v_re=v_re, v_im=v_im, psi_t=psi_t, out=out, u_re=u[0], u_im=u[1],
                   **({"weights": weights} if per_voxel else {}))
    t = _scratch(plan, v_re)
    _launch("pass_cua", kind, dev, c, _ptr(out), *map(_ptr, u),
            *map(_ptr, t), _ptr(v_re), _ptr(v_im), _ptr(psi_t),
            _ptr(weights) if per_voxel else None, 0.0 if per_voxel else float(weights),
            float(lam), float(min_value))
    check_kernel_output("pass_cua", out, *u)
    return out, _store(u, spec, u_out)


# ---------------------------------------------------------------- steps, convolve, spectra


def fused_convolve_transposed(xt: torch.Tensor, k_re, k_im, conj_k: bool = False) -> torch.Tensor:
    """Circular convolution of a (Z, X, Y)-transposed volume with a fused
    kernel spectrum (:func:`kernel_spectrum_fused`), or with its conjugate
    (``conj_k``): passes A, B, C (``fused_dft2.py:2005``).  Returns the
    transposed convolved volume."""
    plan = _plan_for(xt.shape, None, xt.device)
    u = pass_a(xt, plan)
    v = pass_b(*u, k_re, k_im, plan, conj_k=conj_k, out=u)
    return pass_c(*v, plan)


def fused_convolve_spectrum(x: torch.Tensor, k_re, k_im, conj_k: bool = False) -> torch.Tensor:
    """:func:`fused_convolve_transposed` for a natural (Z, Y, X) volume, with
    a transpose in and out (``fused_dft2.py:2034``)."""
    xt = x.transpose(-1, -2).contiguous()
    return fused_convolve_transposed(xt, k_re, k_im, conj_k).transpose(-1, -2).contiguous()


def fused_rl_step_transposed(
    psi_t: torch.Tensor,
    view_t: torch.Tensor,
    k1: Pair,
    k2: Pair,
    weights,
    lam,
    min_value: float,
    conj_k2: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One RL view step on (Z, X, Y)-transposed volumes, five passes:

        A(psi) -> B(x K1) -> CQA -> B(x K2, or conj K2 with ``conj_k2``) -> CU

    (``fused_dft2.py:2051``; the reference step ``src/multiviewnative.cpp:
    191-228``).  The arguments come in the order of
    :func:`..deconv.rl.rl_view_step` (the JAX function takes the weights
    before the spectra).  The passes after A reuse one spectrum pair in
    place.  ``out=psi_t`` updates psi in place."""
    plan = _plan_for(psi_t.shape, None, psi_t.device)
    u = pass_a(psi_t, plan)
    v = pass_b(*u, *k1, plan, out=u)
    u = pass_cqa(*v, view_t, plan, out=v)
    v = pass_b(*u, *k2, plan, conj_k=conj_k2, out=u)
    return pass_cu(*v, psi_t, weights, plan, lam, min_value, out=out)


def fused_forward_transposed(xt: torch.Tensor) -> Pair:
    """Pass A alone (``fused_dft2.py:2097``): the spectrum that seeds the
    carried chain, once per deconvolve call."""
    return pass_a(xt, _plan_for(xt.shape, None, xt.device))


def fused_rl_step_carried(
    psi_t: torch.Tensor,
    u: Pair,
    view_t: torch.Tensor,
    k1: Pair,
    k2: Pair,
    weights,
    lam,
    min_value: float,
    conj_k2: bool = False,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Pair]:
    """One RL view step with pass A of psi carried between steps, four
    passes (``fused_dft2.py:2115``):

        B(x K1) -> CQA -> B(x K2, or conj K2) -> CUA

    ``u`` is pass A of ``psi_t`` (:func:`fused_forward_transposed`, or the
    previous step's carry).  Returns (psi', u(psi')): the same values as
    :func:`fused_rl_step_transposed` followed by pass A, with one read of
    psi' and one pass fewer.  The passes run in place in ``u``'s buffers,
    which hold the returned spectrum; ``out=psi_t`` updates psi in place."""
    plan = _plan_for(psi_t.shape, None, psi_t.device)
    v = pass_b(*u, *k1, plan, out=u)
    u = pass_cqa(*v, view_t, plan, out=v)
    v = pass_b(*u, *k2, plan, conj_k=conj_k2, out=u)
    return pass_cua(*v, psi_t, weights, plan, lam, min_value, out=out, u_out=v)


def sparse_prep_ok(kernel_z: int, Z: int) -> bool:
    """Whether the z-sparse spectrum forwarding serves a kernel of z-extent
    ``kernel_z`` at Z planes: twice its 8-aligned extent fits in Z."""
    return 2 * (-(-int(kernel_z) // 8) * 8) <= int(Z)


def kernel_spectrum_fused(kernel: torch.Tensor, shape: Sequence[int]) -> Pair:
    """The wrapped kernel's spectrum in the fused (Kxp, Z, Y) layout, z and y
    in the interleaved split order (``fused_dft2.py:1593``), forwarded by the
    passes the convolve runs.  The branch follows the shape, as the JAX
    default does: the z-sparse one when :func:`sparse_prep_ok`, else the
    dense one (pass BF)."""
    Z, Y, X = (int(s) for s in shape)
    kernel = kernel.to(torch.float32)
    if sparse_prep_ok(kernel.shape[0], Z):
        return _spectrum_sparse(kernel, (Z, Y, X))
    return _spectrum_dense(kernel, (Z, Y, X))


def _spectrum_dense(kernel: torch.Tensor, shape) -> Pair:
    """Pass A of the wrapped, transposed kernel, then pass BF
    (``fused_dft2.py:1667-1670``)."""
    plan = make_fused_plan(shape)
    kt = wrap_kernel(kernel, shape).transpose(1, 2).contiguous()
    return pass_bf(*pass_a(kt, plan), plan)


@functools.lru_cache(maxsize=64)
def _sparse_table(Z: int, kz: int, R: int, M: int, device: str) -> Pair:
    """The (Z, Zs) DFT table of :func:`_spectrum_sparse` on ``device``, built
    in float64 once per (Z, kz, z split, device) and kept there: row p is
    the split-order frequency of position p, column s the original z index
    of gathered plane s (pad planes are zero in u, their columns unused)."""
    zs = -(-kz // 8) * 8
    cz = kz // 2  # kernel center, z axis
    head = kz - cz
    zorig = np.zeros(zs, np.int64)
    zorig[:head] = np.arange(head)
    zorig[zs - cz :] = Z - cz + np.arange(cz)
    freq = split_perm(Z, (R, M))
    T = np.exp(-2j * np.pi * np.outer(freq, zorig) / Z)
    return (torch.as_tensor(np.asarray(T.real, np.float32), device=device),
            torch.as_tensor(np.asarray(T.imag, np.float32), device=device))


def _spectrum_sparse(kernel: torch.Tensor, shape) -> Pair:
    """The z-sparse branch (``fused_dft2.py:1642-1665``): the wrapped kernel
    occupies only kz planes, so pass A runs on a gathered stack of
    Zs = ceil8(kz) planes and the z-DFT is one (Z, Zs) contraction over them
    (``torch.einsum``, in fp32 whatever the caller set for matmuls: the JAX
    branch pins ``precision=HIGHEST``, :func:`_fp32_matmuls`), against the
    table :func:`_sparse_table` keeps on the device.  Rounded where JAX
    rounds: pass A's spectrum is stored as :func:`spec_dtype` and widened
    for the contraction, and the two sums are formed in f32 and stored as
    :func:`spec_dtype`."""
    Z, Y, X = shape
    plan, spec = make_fused_plan(shape), spec_dtype()
    kz = int(kernel.shape[0])
    zs = -(-kz // 8) * 8
    small = wrap_kernel(kernel, (zs, Y, X))
    u = pass_a(small.transpose(1, 2).contiguous(), make_fused_plan((zs, Y, X)))
    u_re, u_im = (t.float() for t in u)
    tr, ti = _sparse_table(Z, kz, *plan.split_z, str(kernel.device))
    e = lambda a, b: torch.einsum("ps,ksm->kpm", a, b)
    # einsum may return a permuted layout (it does on CUDA); the passes
    # take contiguous (Kxp, Z, Y) spectra
    store = lambda t: t.contiguous().to(spec)
    with _fp32_matmuls():
        return store(e(tr, u_re) - e(ti, u_im)), store(e(tr, u_im) + e(ti, u_re))
