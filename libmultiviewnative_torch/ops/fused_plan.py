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
import math
import os
from concurrent.futures import ThreadPoolExecutor
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


class FusedPlan:
    """The dense packed plan of a (Z, Y, X) shape: x matrices, y stage
    (right-multiplied) and z stage (left-multiplied).

    Making a plan sets only its shape, Kx, Kxp and the stage splits, which
    is all the CUDA passes read (their FFT stage tables come from
    :func:`make_fft_stages`).  The dense matrices, which only the plain
    passes read, are built on first use and kept: an unsplit stage of
    length 14528 holds six 14528² float32 matrices, 5 GB."""

    def __init__(self, shape: Tuple[int, int, int]):
        Z, Y, X = shape
        self.shape = (Z, Y, X)
        self.kxh = X // 2 + 1  # Kx
        self.kxp = -(-self.kxh // 8) * 8  # Kx rounded up to a multiple of 8
        self.split_z, self.split_y = pick_split(Z), pick_split(Y)

    @property
    def kx(self) -> int:
        return self.kxh

    @functools.cached_property
    def _x(self) -> Tuple[np.ndarray, np.ndarray]:
        return _make_x(self.shape[2], self.kxh, self.kxp)

    @property
    def fxp(self) -> np.ndarray:
        """(2*Kxp, X) packed forward x: [cos; pad; -sin; pad]."""
        return self._x[0]

    @property
    def bxp(self) -> np.ndarray:
        """(X, 2*Kxp) packed inverse x: [w*cos/X | pad | -w*sin/X | pad]."""
        return self._x[1]

    @functools.cached_property
    def sy(self) -> SplitSpec:
        return _make_split(self.shape[1], self.split_y, orient="right")

    @functools.cached_property
    def sz(self) -> SplitSpec:
        return _make_split(self.shape[0], self.split_z, orient="left")


def _triple(a: np.ndarray, b: np.ndarray):
    f32 = lambda m: np.asarray(m, np.float32)
    return (f32(a), f32(b), f32(a + b))


# rows of a dense stage matrix built at a time: the whole-array expressions
# of the JAX package, applied to row blocks, give each value bitwise, and a
# (N, N) table at N = 14528 then needs its float32 results only (5 GB for a
# split stage's six) instead of 15 GB of complex128 temporaries
_BLOCK_ROWS = 256


def _by_rows(n_rows: int, fill) -> None:
    """``fill(r0, r1)`` over blocks of rows, on a thread pool when there are
    several (numpy's elementwise functions release the GIL)."""
    blocks = [(r, min(r + _BLOCK_ROWS, n_rows)) for r in range(0, n_rows, _BLOCK_ROWS)]
    if len(blocks) == 1:
        fill(*blocks[0])
        return
    with ThreadPoolExecutor(min(len(blocks), os.cpu_count() or 1)) as pool:
        for done in [pool.submit(fill, *b) for b in blocks]:
            done.result()


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
    qj = np.outer(np.arange(R), np.arange(M)) * (2.0 * np.pi / n)
    f32 = lambda m: np.asarray(m, np.float32)
    twf_q = np.exp(-1j * qj)  # (R, M)
    twi_q = np.exp(+1j * qj)
    wf = tuple(np.empty((R * M, M), np.float32) for _ in range(3))
    wi = tuple(np.empty((R * M, M), np.float32) for _ in range(3))

    def fill(j0, j1):
        # rows j0..j1 of the (M, M) DFT matrices, then of each per-q block of
        # the (R*M, M) stacks (twiddle-folded when R > 1)
        jm = np.outer(np.arange(j0, j1), np.arange(M)) * (2.0 * np.pi / M)
        Wf = np.exp(-1j * jm)
        Wi = np.exp(+1j * jm) / M
        for q in range(R):
            if R == 1:
                fq, iq = Wf, Wi
            elif orient == "right":
                fq = twf_q[q][j0:j1, None] * Wf
                iq = Wi * twi_q[q][None, :]
            else:
                fq = Wf * twf_q[q][None, :]
                iq = twi_q[q][j0:j1, None] * Wi
            for out, F in ((wf, fq), (wi, iq)):
                for o, part in zip(out, _triple(F.real, F.imag)):
                    o[q * M + j0 : q * M + j1] = part

    _by_rows(M, fill)
    return SplitSpec(
        R=R,
        M=M,
        wf=wf,
        twf=(f32(np.cos(qj)), f32(-np.sin(qj))),
        wi=wi,
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
    return FusedPlan(shape)


def _make_x(X: int, kx: int, kxp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(fxp, bxp), the packed forward and inverse x matrices."""
    # hermitian doubling weights for the real x-inverse
    w = np.full(kx, 2.0)
    w[0] = 1.0
    if X % 2 == 0:
        w[-1] = 1.0

    fxp = np.zeros((2 * kxp, X), np.float32)
    bxp = np.zeros((X, 2 * kxp), np.float32)

    def fill(k0, k1):
        # x-frequencies k0..k1: rows of fxp, columns of bxp
        tx = 2.0 * np.pi * np.outer(np.arange(k0, k1), np.arange(X)) / X
        fxp[k0:k1] = np.cos(tx)
        fxp[kxp + k0 : kxp + k1] = -np.sin(tx)
        bxp[:, k0:k1] = (w[None, k0:k1] * np.cos(tx).T) / X
        bxp[:, kxp + k0 : kxp + k1] = -(w[None, k0:k1] * np.sin(tx).T) / X

    _by_rows(kx, fill)
    return fxp, bxp


def split_perm(n: int, split: Tuple[int, int]) -> np.ndarray:
    """Index array mapping interleaved stage-output position -> natural
    frequency: position q*M+p holds frequency R*p+q.  Identity at R=1."""
    R, M = split
    idx = np.empty(n, np.int64)
    for q in range(R):
        idx[q * M : (q + 1) * M] = np.arange(M) * R + q
    return idx


# ---------------------------------------------------------------- FFT stages
# The port's own tables for the FFT stages of passes A, BF, B, C and CQA
# (ops/csrc/fft_stage.cuh, and ops/csrc/fft_long.cuh for the long axes); the
# JAX package has no counterpart.

FFT_MAX_STAGES = 16  # kMaxStages in fft_stage.cuh
# the longest length a shared-memory stage holds: a tile of two sequences of
# n complex float32 values in one block's 232448 bytes (kSmemMax, kMinTile)
DIRECT_MAX = 14528
# the largest radix of a generic stage (kMaxGenericRadix)
MAX_RADIX = 1024
# the longest axis the CUDA passes serve: a Bluestein transform of 2^25
# points pads to 2^26 = 8192², the longest power of two whose four-step
# factors both fit a shared-memory stage (kMaxLength)
MAX_LENGTH = 2**25

KINDS = ("direct", "four_step", "bluestein")  # LmvnFft.kind 0, 1, 2


class FftStages(NamedTuple):
    """The plan of a length-n FFT, of one of three kinds.

    ``direct``: an in-place mixed-radix decimation-in-time FFT in one
    block's shared memory.  ``radices`` in the order the stages run.  Stage
    j combines sub-DFTs of length m_j = radices[0] · ... · radices[j-1] into
    DFTs of length L_j = radices[j] · m_j: for each block b and k' < m_j,
    the values at b·L_j + t·m_j + k' (t < r) are multiplied by
    W_{L_j}^{t·k'} and replaced by their r-point DFT, output k1 at
    b·L_j + k1·m_j + k'.  W_L = exp(-2πi/L) forward; the inverse conjugates
    every table entry.  ``pos[i]`` is where input i is stored before the
    first stage (the mixed-radix digit reversal), so the last stage leaves
    frequency f at position f.  ``tw`` (complex64) holds the twiddles
    W_{L_j}^{t·k'} of stage j at m_j - 1 + (t - 1)·m_j + k' (n - 1 values in
    all), then for each stage whose radix is not 2, 4 or 8, in stage order,
    its r roots W_r^s.

    ``four_step`` (Bailey), n = N1·N2, ``parts`` the direct plans of N1 and
    N2, run through HBM: input j = N2·j1 + j2 at position j; the N1-point
    transforms over j1 (stride N2), times W_n^{j2·k1}; then the N2-point
    transforms over j2, which leave frequency k1 + N1·k2 at position
    N2·k1 + k2 (:func:`spectrum_at`).  The inverse runs the two steps in
    reverse, the twiddle after the N2-point transforms, from that order back
    to the natural one.

    ``bluestein`` (chirp-z), any n: ``chirp`` b_j = exp(iπ j²/n) (complex64,
    from float64), ``parts`` the plan of the padded length ``m``, the power
    of two at least 2n - 1 (direct or four-step), ``bhat`` the m-point
    spectrum of the chirp wrapped to m (b̃_j = b_j and b̃_{m-j} = b_j for
    j < n, zeros between), times 1/m, from float64.  Forward: x_j · conj(b_j)
    zero-padded to m, the m-point FFT, × bhat, the inverse m-point FFT, the
    first n values × conj(b_k): frequency k at position k.  The inverse takes
    the conjugate chirp: × b_j, × conj(bhat[(m - k) mod m]), × b_k.

    Only a direct plan has ``radices``, ``tw`` and ``pos``."""

    n: int
    radices: Tuple[int, ...]
    tw: np.ndarray
    pos: np.ndarray
    kind: str = "direct"
    parts: Tuple["FftStages", ...] = ()
    m: int = 0
    chirp: np.ndarray = None
    bhat: np.ndarray = None


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


def is_direct(n: int, direct_max: int = DIRECT_MAX, radix_max: int = MAX_RADIX) -> bool:
    """Whether a length-n FFT runs in one block's shared memory: n at most
    ``direct_max`` and every radix at most ``radix_max``."""
    if not 2 <= n <= direct_max:
        return False
    radices = fft_radices(n)
    return len(radices) <= FFT_MAX_STAGES and max(radices) <= radix_max


def plan_kind(n: int, direct_max: int = DIRECT_MAX,
              radix_max: int = MAX_RADIX) -> Tuple[str, Tuple[int, ...]]:
    """(kind, sizes) of a length-n FFT: ("direct", ()) where
    :func:`is_direct`; ("four_step", (N1, N2)) where n splits into two
    direct lengths, N1 ≤ N2 the split nearest √n; else ("bluestein", (m,)),
    m the power of two at least 2n - 1.  ``direct_max`` and ``radix_max``
    are lowered only by tests, to take the four-step and Bluestein kinds at
    small lengths."""
    if n < 1:
        raise ValueError(f"FFT length must be positive, got {n}")
    direct = functools.partial(is_direct, direct_max=direct_max, radix_max=radix_max)
    if n == 1 or direct(n):
        return "direct", ()
    for n1 in range(math.isqrt(n), 1, -1):
        if n % n1 == 0 and direct(n1) and direct(n // n1):
            return "four_step", (n1, n // n1)
    return "bluestein", (1 << (2 * n - 2).bit_length(),)


def spectrum_at(stages: FftStages, k: np.ndarray) -> np.ndarray:
    """Where a forward transform of the plan leaves frequency k (and where
    its inverse takes it): k, or N2·(k mod N1) + k div N1 for the four-step
    kind (``spectrum_at`` of fft_long.cuh)."""
    if stages.kind != "four_step":
        return k
    n1, n2 = (p.n for p in stages.parts)
    return (k % n1) * n2 + k // n1


def make_fft_stages(n: int, direct_max: int = DIRECT_MAX, radix_max: int = MAX_RADIX) -> FftStages:
    """The plan and tables of a length-n FFT (float64, stored float32), of
    the kind :func:`plan_kind` gives (``direct_max`` and ``radix_max`` as
    there, for tests only)."""
    return _make_fft_stages(int(n), int(direct_max), int(radix_max))


@functools.lru_cache(maxsize=64)
def _make_fft_stages(n: int, direct_max: int, radix_max: int) -> FftStages:
    kind, sizes = plan_kind(n, direct_max, radix_max)
    if kind == "four_step":
        parts = tuple(_make_fft_stages(s, direct_max, radix_max) for s in sizes)
        return FftStages(n, (), np.zeros(0, np.complex64), np.zeros(0, np.int32), kind, parts)
    if kind == "bluestein":
        (m,) = sizes
        if plan_kind(m, direct_max, radix_max)[0] == "bluestein":
            raise ValueError(f"length {n}: its Bluestein padding {m} has no direct or four-step plan")
        inner = _make_fft_stages(m, direct_max, radix_max)
        j = np.arange(n, dtype=np.int64)
        b = np.exp(1j * np.pi * ((j * j) % (2 * n)) / n)  # exp(iπ j²/n), j² taken mod 2n
        wrapped = np.zeros(m, np.complex128)
        wrapped[:n] = b
        wrapped[m - n + 1 :] = b[1:][::-1]
        bhat = np.fft.fft(wrapped) / m
        return FftStages(n, (), np.zeros(0, np.complex64), np.zeros(0, np.int32), kind, (inner,), m,
                         b.astype(np.complex64), bhat.astype(np.complex64))
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
