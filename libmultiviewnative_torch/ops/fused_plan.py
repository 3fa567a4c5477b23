"""Constant stage matrices of the fused RL-step engine, in numpy.

Counterpart of the plan half of ``libmultiviewnative_tpu/ops/pallas/
fused_dft2.py`` (``SplitSpec``, ``FusedPlan``, ``pick_split``,
``_make_split``, ``_make_fused_plan``, ``split_perm``), with the same numpy
expressions, so the constants are bitwise those of the JAX package.

Layouts (plan shape (Z, Y, X), Kx = X//2 + 1, Kxp = Kx rounded up to 8):

* volumes live transposed, (Z, X, Y);
* spectra are split (re, im) float32 pairs shaped (Kxp, Z, Y), with the z and
  y axes in the interleaved order of :func:`split_perm` and the pad rows
  k in [Kx, Kxp) zero;
* ``fxp`` (2Kxp, X) packs the forward x-rfft rows [cos; pad; -sin; pad];
  ``bxp`` (X, 2Kxp) the hermitian inverse with 1/X folded in;
* each split stage of length N = R·M holds twiddle-folded per-q (M, M)
  matrices stacked (R·M, M) as Karatsuba triples (re, im, re + im).

Only the dense packed x-mode with twiddle-folded Karatsuba stages is ported.
The JAX package's other plan forms (the presplit bf16 copies, the stacked
complex form, the hermitian fold and split-x) are not: ``fold_x=True``,
``twfold=False`` and ``cmul="stacked"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

_LATER = "is not ported yet (ROADMAP queue 1, P7)"


class SplitSpec(NamedTuple):
    """Constants for one split (or dense, R=1) DFT stage of length N = R·M.

    ``wf``/``wi``: forward/inverse stage-matrix Karatsuba triples (A, B, A+B),
    (R·M, M) per-q stacks when R > 1; the inverse carries 1/M.
    ``twf``/``twi``: (R, M) twiddle re/im pairs.  ``omf``/``omi``: complex
    (R, R) scalar tables omega_R^{±qr}, the inverse carrying 1/R."""

    R: int
    M: int
    wf: Tuple[np.ndarray, np.ndarray, np.ndarray]
    twf: Tuple[np.ndarray, np.ndarray]
    wi: Tuple[np.ndarray, np.ndarray, np.ndarray]
    twi: Tuple[np.ndarray, np.ndarray]
    omf: np.ndarray
    omi: np.ndarray


class FusedPlan(NamedTuple):
    """The dense packed plan: x matrices, y stage (right-multiplied) and z
    stage (left-multiplied)."""

    fxp: np.ndarray  # (2*Kxp, X) packed forward x: [cos; pad; -sin; pad]
    sy: SplitSpec
    sz: SplitSpec
    bxp: np.ndarray  # (X, 2*Kxp) packed inverse x: [w*cos/X | pad | -w*sin/X | pad]
    shape: Tuple[int, int, int]  # (Z, Y, X)
    kxh: int  # Kx = X//2 + 1
    kxp: int  # Kx rounded up to a multiple of 8

    @property
    def kx(self) -> int:
        return self.kxh


def _triple(a: np.ndarray, b: np.ndarray):
    f32 = lambda m: np.asarray(m, np.float32)
    return (f32(a), f32(b), f32(a + b))


def pick_split(n: int) -> Tuple[int, int]:
    """(R, M) for a length-n stage: split only when n is a multiple of 128
    above 128, with M = 128."""
    if n % 128 == 0 and n > 128:
        return (n // 128, 128)
    return (1, n)


def _make_split(
    n: int, split: Tuple[int, int], orient: str = "right",
    twfold: bool = True, cmul: str = "karatsuba",
) -> SplitSpec:
    """``orient``: 'right' for the y stage (data @ W), 'left' for the z stage
    (W @ data).  The per-q twiddle diagonal is folded into the stage
    matrices (the only form ported)."""
    if not twfold:
        raise NotImplementedError(f"twfold=False {_LATER}")
    if cmul != "karatsuba":
        raise NotImplementedError(f"cmul={cmul!r} {_LATER}")
    R, M = split
    assert R * M == n, (R, M, n)
    jm = np.outer(np.arange(M), np.arange(M)) * (2.0 * np.pi / M)
    qj = np.outer(np.arange(R), np.arange(M)) * (2.0 * np.pi / n)
    f32 = lambda m: np.asarray(m, np.float32)
    Wf = np.exp(-1j * jm)
    Wi = np.exp(+1j * jm) / M
    if R > 1:
        twf_q = np.exp(-1j * qj)  # (R, M)
        twi_q = np.exp(+1j * qj)
        if orient == "right":
            fq = [twf_q[q][:, None] * Wf for q in range(R)]
            iq = [Wi * twi_q[q][None, :] for q in range(R)]
        else:
            fq = [Wf * twf_q[q][None, :] for q in range(R)]
            iq = [twi_q[q][:, None] * Wi for q in range(R)]
    else:
        fq, iq = [Wf], [Wi]
    Fs = np.concatenate(fq, axis=0)  # (R*M, M) folded, (M, M) plain
    Is = np.concatenate(iq, axis=0)
    return SplitSpec(
        R=R,
        M=M,
        wf=_triple(Fs.real, Fs.imag),
        twf=(f32(np.cos(qj)), f32(-np.sin(qj))),
        wi=_triple(Is.real, Is.imag),
        twi=(f32(np.cos(qj)), f32(np.sin(qj))),
        omf=np.exp(-2j * np.pi / R * np.outer(np.arange(R), np.arange(R))),
        omi=np.exp(+2j * np.pi / R * np.outer(np.arange(R), np.arange(R))) / R,
    )


def make_fused_plan(
    shape: Tuple[int, int, int],
    fold_x: bool = False,
    twfold: bool = True,
) -> FusedPlan:
    """The plan for a (Z, Y, X) shape, each stage split by
    :func:`pick_split`.  The hermitian-fold (``fold_x``) and untwiddled
    (``twfold=False``) forms raise; the port has no split-x or presplit form
    at all (the JAX package selects those by environment knobs at trace
    time)."""
    if fold_x:
        raise NotImplementedError(f"the fold_x plan form {_LATER}")
    if not twfold:
        raise NotImplementedError(f"twfold=False {_LATER}")
    return _make_fused_plan(tuple(int(s) for s in shape))


@functools.lru_cache(maxsize=64)
def _make_fused_plan(shape: Tuple[int, int, int]) -> FusedPlan:
    Z, Y, X = shape
    kx = X // 2 + 1
    splits = (pick_split(Z), pick_split(Y))

    tx = 2.0 * np.pi * np.outer(np.arange(kx), np.arange(X)) / X

    # hermitian doubling weights for the real x-inverse
    w = np.full(kx, 2.0)
    w[0] = 1.0
    if X % 2 == 0:
        w[-1] = 1.0

    kxp = -(-kx // 8) * 8  # 8-row aligned pack stride
    fxp = np.zeros((2 * kxp, X), np.float32)
    fxp[:kx] = np.cos(tx)
    fxp[kxp : kxp + kx] = -np.sin(tx)
    bxp = np.zeros((X, 2 * kxp), np.float32)
    bxp[:, :kx] = (w[None, :] * np.cos(tx).T) / X
    bxp[:, kxp : kxp + kx] = -(w[None, :] * np.sin(tx).T) / X

    f32 = lambda a: np.asarray(a, np.float32)
    return FusedPlan(
        fxp=f32(fxp),
        sy=_make_split(Y, splits[1], orient="right"),
        sz=_make_split(Z, splits[0], orient="left"),
        bxp=f32(bxp),
        shape=(Z, Y, X),
        kxh=kx,
        kxp=kxp,
    )


def split_perm(n: int, split: Tuple[int, int]) -> np.ndarray:
    """Index array mapping interleaved stage-output position -> natural
    frequency: position q*M+p holds frequency R*p+q.  Identity at R=1."""
    R, M = split
    idx = np.empty(n, np.int64)
    for q in range(R):
        idx[q * M : (q + 1) * M] = np.arange(M) * R + q
    return idx


# ---------------------------------------------------------------- FFT stages
# The port's own tables for the shared-memory FFT stages of passes A, BF, B,
# C and CQA (ops/csrc/fft_stage.cuh); the JAX package has no counterpart.

FFT_MAX_STAGES = 16  # kMaxStages in fft_stage.cuh


class FftStages(NamedTuple):
    """An in-place mixed-radix decimation-in-time FFT of length n.

    ``radices`` in the order the stages run.  Stage j combines sub-DFTs of
    length m_j = radices[0] · ... · radices[j-1] into DFTs of length
    L_j = radices[j] · m_j: for each block b and k' < m_j, the values at
    b·L_j + t·m_j + k' (t < r) are multiplied by W_{L_j}^{t·k'} and replaced
    by their r-point DFT, output k1 at b·L_j + k1·m_j + k'.  W_L = exp(-2πi/L)
    forward; the inverse conjugates every table entry.

    ``pos[i]`` is where input i is stored before the first stage (the
    mixed-radix digit reversal), so the last stage leaves frequency f at
    position f.  ``tw`` (complex64) holds the twiddles W_{L_j}^{t·k'} of stage
    j at m_j - 1 + (t - 1)·m_j + k' (n - 1 values in all), then for each stage
    whose radix is not 2, 4 or 8, in stage order, its r roots W_r^s."""

    n: int
    radices: Tuple[int, ...]
    tw: np.ndarray
    pos: np.ndarray


def fft_radices(n: int) -> Tuple[int, ...]:
    """The stage radices of a length-n transform, in the order they run:
    the factors other than 2, 3, 5 and 7 (one generic stage each) first,
    then 7s, 5s, 3s, then the power of two as 8s with one 4, two 4s or one 2
    for the remainder."""
    if n < 1:
        raise ValueError(f"FFT length must be positive, got {n}")
    rest, twos = n, 0
    while rest % 2 == 0:
        rest //= 2
        twos += 1
    small = []
    for p in (3, 5, 7):
        while rest % p == 0:
            rest //= p
            small.append(p)
    generic, p = [], 11
    while rest > 1:
        while rest % p == 0:
            rest //= p
            generic.append(p)
        p += 2
    eights, left = divmod(twos, 3)
    pow2 = [8] * eights
    if left == 1 and eights:
        pow2[-1:] = [4, 4]
    elif left == 1:
        pow2.append(2)
    elif left == 2:
        pow2.append(4)
    return tuple(generic[::-1] + small[::-1] + pow2)


@functools.lru_cache(maxsize=64)
def make_fft_stages(n: int) -> FftStages:
    """The stage plan and tables of a length-n FFT (float64, stored float32)."""
    radices = fft_radices(n)
    if len(radices) > FFT_MAX_STAGES:
        raise ValueError(f"length {n} needs {len(radices)} FFT stages, over {FFT_MAX_STAGES}")
    tw = [np.zeros(0)]
    m = 1
    for r in radices:
        L = r * m
        t, k = np.meshgrid(np.arange(1, r), np.arange(m), indexing="ij")
        tw.append(np.exp(-2j * np.pi * (t * k) / L).ravel())
        m = L
    for r in radices:
        if r not in (2, 4, 8):
            tw.append(np.exp(-2j * np.pi * np.arange(r) / r))
    # position p = sum_j d_j m_j (d_j < r_j) holds input sum_j d_j prod_{i>j} r_i
    pos = np.zeros(n, np.int64)
    p = np.arange(n)
    src = np.zeros(n, np.int64)
    rem = p.copy()
    above = int(np.prod(radices)) if radices else 1
    for r in radices:
        above //= r
        src += (rem % r) * above
        rem //= r
    pos[src] = p
    return FftStages(
        n=n,
        radices=radices,
        tw=np.concatenate(tw).astype(np.complex64),
        pos=pos.astype(np.int32),
    )
