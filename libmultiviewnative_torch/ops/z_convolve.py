"""The fft engine's hand route: cuFFT on the x and y axes, one hand-written
pass for the z axis, the product and the scaling.

:func:`..core.convolve.convolve_spectrum` computes irfftn(rfftn(x) · k̂).
cuFFT runs its x and y axes near the card's bytes but its z axis, strided
by a whole plane of the half spectrum, far below them (31 % at Z = 300,
PERF.md §5), and the product (K3) and PyTorch's 1/N scaling each read and
write the whole spectrum once more.  On this route:

1. cuFFT forwards x (r2c) and y (c2c) only, the r2c writing straight into a
   half spectrum with (X//2+1, Z, Y) in memory, the order the engine's
   kernel spectra have (a 3D ``rfftn`` on the card returns it), so no copy
   is added;
2. :func:`z_convolve`, one launch of ``ops/csrc/z_convolve.cu``
   (``lmvn_fft::z_convolve_kernel``), does the z FFT, the product with k̂
   (or its conjugate), the inverse z FFT and the 1/(Z·Y·X) in shared
   memory, in place, with the FFT stages of ``fft_stage.cuh``;
3. cuFFT runs the inverse y (in place) and the c2r along x, unscaled.

cuFFT is called through its C API (``cufftMakePlanMany64``, the library
PyTorch already loaded), since the strided r2c output has no ``torch.fft``
form: ``torch.fft.rfft2`` would copy the spectrum to make its y transform
contiguous.  The plans are cached by device and shape; their work areas
come from PyTorch's caching allocator, as ``torch.fft``'s do, so they count
in ``torch.cuda.max_memory_allocated``.

:func:`takes_z_pass` is the rule (what the route serves, read from the
operands); :func:`z_pass_convolve_plain` is the plain version, the same
decomposition in ``torch.fft``, which the card's route is held against.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Optional

import torch

from . import _build
from .elementwise import _stream, _wants_grad
from .fused import _FftArgs
from .fused_plan import FFT_MAX_STAGES, fft_radices, is_direct, make_fft_stages
from ..utils.trace import check_kernel_output

# launches of the hand-written pass; a plain-version call never counts
launches = {"z_convolve": 0}


def reset_launches() -> None:
    launches["z_convolve"] = 0


# the radices of the stages with butterflies of their own (fft_stage.cuh
# radix_stage); a length that needs a generic stage keeps cuFFT's 3D route
_RADICES = (2, 3, 4, 5, 7, 8)


def z_length_ok(Z: int) -> bool:
    """Whether the hand pass serves a z axis of length ``Z``: a direct plan
    (2 to 14528, where a tile of two columns still fits one block's shared
    memory) of stages of radix 2, 3, 4, 5, 7 and 8 (every prime factor at
    most 7)."""
    Z = int(Z)
    return is_direct(Z) and all(r in _RADICES for r in fft_radices(Z))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def takes_z_pass(x: torch.Tensor, kernel_hat: torch.Tensor) -> bool:
    """Whether :func:`..core.convolve.convolve_spectrum` of a float32 volume
    ``x`` (or a batch of them) against ``kernel_hat`` takes the hand route:
    on a CUDA device, with one complex64 kernel spectrum of the volume's
    half-spectrum shape, no operand requiring grad (the 3D route is the
    differentiable one), a z axis :func:`z_length_ok` serves and y and x of
    at least 2.  Anything else (the CPU, a stack of kernels against one x,
    a z length with a generic radix) keeps the 3D route."""
    if x.ndim < 3 or kernel_hat.ndim != 3:
        return False
    if not (_on_card(x) and x.device == kernel_hat.device):
        return False
    if x.dtype != torch.float32 or kernel_hat.dtype != torch.complex64 or kernel_hat.is_conj():
        return False
    if _wants_grad(x, kernel_hat):
        return False
    Z, Y, X = (int(s) for s in x.shape[-3:])
    return (tuple(kernel_hat.shape) == (Z, Y, X // 2 + 1) and min(Y, X) >= 2
            and z_length_ok(Z))


# ---------------------------------------------------------------- plain version


def z_convolve_plain(spec: torch.Tensor, k_hat: torch.Tensor, conj_k: bool,
                     n: int) -> torch.Tensor:
    """What :func:`z_convolve` computes on a half spectrum whose x and y are
    forwarded: the z FFT, the product with k̂ (or conj k̂), the unscaled
    inverse z FFT and 1/n (n = Z·Y·X)."""
    s = torch.fft.fft(spec, dim=-3)
    s = s * (k_hat.conj() if conj_k else k_hat)
    return torch.fft.ifft(s, dim=-3, norm="forward") * (1.0 / n)


def z_pass_convolve_plain(x: torch.Tensor, k_hat: torch.Tensor,
                          conj_k: bool = False) -> torch.Tensor:
    """The hand route's decomposition in ``torch.fft``: x and y forwarded
    (``rfft2``), :func:`z_convolve_plain`, the unscaled x and y inverse."""
    Z, Y, X = (int(s) for s in x.shape[-3:])
    s = z_convolve_plain(torch.fft.rfft2(x), k_hat, conj_k, Z * Y * X)
    return torch.fft.irfft2(s, s=(Y, X), norm="forward")


# ---------------------------------------------------------------- cuFFT

_CUFFT_R2C, _CUFFT_C2R, _CUFFT_C2C = 0x2A, 0x2C, 0x29
_CUFFT_FORWARD, _CUFFT_INVERSE = -1, 1
# PyTorch's CUDA build loads cuFFT by its soname; dlopen finds it there
_CUFFT_NAMES = ("libcufft.so.11", "libcufft.so.12", "libcufft.so")
_LL = ctypes.c_longlong
_cufft_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cufft() -> ctypes.CDLL:
    """cuFFT's C API, the library already in the process."""
    global _cufft_lib
    if _cufft_lib is None:
        for name in _CUFFT_NAMES:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise RuntimeError(f"cuFFT is not loadable under any of {_CUFFT_NAMES}")
        P = ctypes.c_void_p
        for fn, args in (
            ("cufftCreate", (ctypes.POINTER(ctypes.c_int),)),
            ("cufftSetAutoAllocation", (ctypes.c_int, ctypes.c_int)),
            ("cufftMakePlanMany64", (ctypes.c_int, ctypes.c_int, ctypes.POINTER(_LL),
                                     ctypes.POINTER(_LL), _LL, _LL, ctypes.POINTER(_LL), _LL,
                                     _LL, ctypes.c_int, _LL, ctypes.POINTER(ctypes.c_size_t))),
            ("cufftSetStream", (ctypes.c_int, P)),
            ("cufftSetWorkArea", (ctypes.c_int, P)),
            ("cufftExecR2C", (ctypes.c_int, P, P)),
            ("cufftExecC2R", (ctypes.c_int, P, P)),
            ("cufftExecC2C", (ctypes.c_int, P, P, ctypes.c_int)),
            ("cufftDestroy", (ctypes.c_int,)),
        ):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        _cufft_lib = lib
    return _cufft_lib


def _ok(what: str, res: int) -> None:
    if res != 0:
        raise RuntimeError(f"cuFFT {what} failed: cufftResult {res}")


def _plan_many(n, inembed, istride, idist, onembed, ostride, odist, kind, batch):
    """A cuFFT plan (rank 1) with no work area of its own: (handle, bytes of
    the work area it needs)."""
    lib = _cufft()
    handle, work = ctypes.c_int(), ctypes.c_size_t()
    _ok("cufftCreate", lib.cufftCreate(ctypes.byref(handle)))
    try:
        _ok("cufftSetAutoAllocation", lib.cufftSetAutoAllocation(handle, 0))
        arr = lambda v: (_LL * 1)(v)  # noqa: E731
        _ok("cufftMakePlanMany64", lib.cufftMakePlanMany64(
            handle, 1, arr(n), arr(inembed), istride, idist, arr(onembed), ostride, odist, kind,
            batch, ctypes.byref(work)))
    except Exception:
        lib.cufftDestroy(handle)
        raise
    return handle.value, int(work.value)


class _Plans:
    """The three cuFFT plans and the z stage tables of one (Z, Y, X) shape
    on one device.  Half spectrum s: element (z, y, k) at (k·Z + z)·Y + y.

    * ``r2c``: X real samples at stride 1 a row, Z·Y rows, into s at stride
      Z·Y a frequency, row (z, y) at z·Y + y;
    * ``c2c``: the Y values of each of the Kx·Z rows of s, in place, both
      directions;
    * ``c2r``: back from s at stride Z·Y into contiguous rows of X."""

    def __init__(self, shape, device: torch.device):
        Z, Y, X = shape
        self.shape, self.device = shape, device
        self.kx, planes = X // 2 + 1, Z * Y
        self.handles = []
        with torch.cuda.device(device):
            for args in ((X, X, 1, X, self.kx, planes, 1, _CUFFT_R2C, planes),
                         (Y, Y, 1, Y, Y, 1, Y, _CUFFT_C2C, self.kx * Z),
                         (X, self.kx, planes, 1, X, 1, X, _CUFFT_C2R, planes)):
                self.handles.append(_plan_many(*args))
            st = make_fft_stages(Z)
            tw = torch.view_as_real(torch.from_numpy(st.tw)).contiguous().to(device)
            pos = torch.from_numpy(st.pos).to(device)
        self.keep = (tw, pos)
        radix = (ctypes.c_int * FFT_MAX_STAGES)(*st.radices)
        self.fz = _FftArgs(Z, len(st.radices), radix, tw.data_ptr(), pos.data_ptr())
        self.work = max(w for _, w in self.handles)
        self.lock = threading.Lock()

    def run(self, which: int, *args) -> None:
        """Execute plan ``which`` (0 r2c, 1 c2c, 2 c2r) on the current
        stream with ``self.area`` as its work area."""
        lib, (handle, _) = _cufft(), self.handles[which]
        _ok("cufftSetStream", lib.cufftSetStream(handle, _stream(self.device)))
        _ok("cufftSetWorkArea", lib.cufftSetWorkArea(handle, self.area))
        fn = (lib.cufftExecR2C, lib.cufftExecC2C, lib.cufftExecC2R)[which]
        _ok(fn.__name__, fn(handle, *args))

    def destroy(self) -> None:
        torch.cuda.synchronize(self.device)  # no launch of these plans is in flight
        for handle, _ in self.handles:
            _cufft().cufftDestroy(handle)
        self.handles = []


_PLAN_CACHE_SIZE = 8
_plans: "OrderedDict[tuple, _Plans]" = OrderedDict()


def _plans_for(shape, device: torch.device) -> _Plans:
    key = (str(device), tuple(shape))
    with _lock:
        got = _plans.get(key)
        if got is None:
            got = _plans[key] = _Plans(tuple(shape), device)
            while len(_plans) > _PLAN_CACHE_SIZE:
                _plans.popitem(last=False)[1].destroy()
        _plans.move_to_end(key)
        return got


# ---------------------------------------------------------------- the route


def z_convolve(spec: torch.Tensor, k_hat: torch.Tensor, conj_k: bool, shape,
               plans: Optional[_Plans] = None) -> torch.Tensor:
    """The hand pass on ``spec``, the (X//2+1, Z, Y)-ordered half spectrum
    of one (Z, Y, X) volume with x and y forwarded (logical shape (Z, Y,
    X//2+1)), in place: z FFT, × k̂ (or conj k̂), inverse z FFT, × 1/(Z·Y·X).
    ``k_hat`` may have any strides."""
    Z, Y, X = shape
    dev = spec.device
    plans = plans or _plans_for(shape, dev)
    err = _build.library().lmvn_z_convolve(
        dev.index, spec.data_ptr(), k_hat.data_ptr(), *k_hat.stride(), int(bool(conj_k)),
        ctypes.addressof(plans.fz), Y, X // 2 + 1, 1.0 / (Z * Y * X), _stream(dev))
    _build.check("z_convolve", err)
    launches["z_convolve"] += 1
    check_kernel_output("z_convolve", spec)
    return spec


def z_pass_convolve(x: torch.Tensor, k_hat: torch.Tensor, conj_k: bool = False,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (Z, Y, X) float32 volume on the card convolved with ``k_hat``
    through the hand route (see the module's docstring): four cuFFT
    executions and one hand-written launch; the result written to ``out``
    (a contiguous float32 volume) or a new tensor."""
    shape = tuple(int(s) for s in x.shape[-3:])
    Z, Y, X = shape
    dev = x.device
    plans = _plans_for(shape, dev)
    # cuFFT reads and writes the real rows as if they were complex: 8-byte aligned
    if not x.is_contiguous() or x.data_ptr() % 8:
        x = x.clone(memory_format=torch.contiguous_format)
    res = out if out is not None and out.data_ptr() % 8 == 0 else torch.empty(
        shape, dtype=torch.float32, device=dev)
    spec = torch.empty_strided((Z, Y, plans.kx), (Y, 1, Z * Y), dtype=torch.complex64, device=dev)
    area = torch.empty(plans.work, dtype=torch.uint8, device=dev) if plans.work else None
    with torch.cuda.device(dev), plans.lock:
        plans.area = None if area is None else area.data_ptr()
        plans.run(0, x.data_ptr(), spec.data_ptr())
        plans.run(1, spec.data_ptr(), spec.data_ptr(), _CUFFT_FORWARD)
        z_convolve(spec, k_hat, conj_k, shape, plans)
        plans.run(1, spec.data_ptr(), spec.data_ptr(), _CUFFT_INVERSE)
        plans.run(2, spec.data_ptr(), res.data_ptr())
    return res if out is None or res is out else out.copy_(res)
