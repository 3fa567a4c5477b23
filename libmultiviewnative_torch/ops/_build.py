"""Build and bind the hand-written CUDA kernels.

At first use, ``nvcc`` compiles the sources under ``ops/csrc/`` into one
shared library with a plain C interface, in ``build/torch_kernels/<hash>/``
beside the package (a directory ``.gitignore`` lists), keyed by a hash of
the sources, the headers and the flags.  Each unit is compiled by its own
``nvcc`` process, all started together, and the objects are then linked:
``elementwise.cu``, ``fused.cu`` (the passes' entries, no kernels),
``fft_long.cu`` (the long axes' gathers, scatters and chirp launches) and
``fft_tiles.cu`` once per tile width of the FFT stages (``-DLMVN_TILE``),
each holding that width's 13 stage kernels and 2 column FFTs: 15.6-17.5 s
on an H100 host with 8 cores before the long axes, where one ``nvcc`` over
the 52 stage kernels would take about three times the longest unit.  The library is loaded with ``ctypes``: every pointer
and the stream go in as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

No PyTorch headers are compiled (that costs minutes per build), and no
``--use_fast_math``: it would change ``1/x`` and ``sqrtf``.  ``-fmad=false``
keeps every multiply and add rounded on its own, as in the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("fft_long.cuh", "fft_stage.cuh", "rl_update.cuh")
# the tile widths of the FFT stages (with_tile in fft_stage.cuh)
_TILES = (16, 8, 4, 2)
# (source, flags, object stem) of each unit
_UNITS = (("elementwise.cu", (), "elementwise"), ("fused.cu", (), "fused"),
          ("fft_long.cu", (), "fft_long")) + tuple(
    ("fft_tiles.cu", (f"-DLMVN_TILE={p}",), f"fft_tiles{p}") for p in _TILES
)
_SOURCES = tuple(dict.fromkeys(source for source, _, _ in _UNITS))
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # device, out, psi, integral, w, w_scalar, lam, min_value, n, batch, stream
    "lmvn_rl_update": (
        ctypes.c_int, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_longlong, ctypes.c_longlong, _P,
    ),
    # device, out, view, integral, n, batch, stream
    "lmvn_quotient": (
        ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P,
    ),
    # device, out, x, k, batch, nk, conj_k, stream
    "lmvn_spectral_multiply": (
        ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, _P,
    ),
    # device, plan, u_re, u_im, t_re, t_im, xt, work, work values, stream
    "lmvn_fused_pass_a": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P),
    # device, plan, o_re, o_im, u_re, u_im, k_re, k_im, conj_k, work, work
    # values, stream
    "lmvn_fused_pass_b": (
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, ctypes.c_longlong, _P,
    ),
    # device, plan, u_re, u_im, t_re, t_im, v_re, v_im, view, work, work
    # values, stream
    "lmvn_fused_pass_cqa": (
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P,
    ),
    # device, plan, out, t_re, t_im, v_re, v_im, psi, w, w_scalar, lam,
    # min_value, work, work values, stream
    "lmvn_fused_pass_cu": (
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, _P, ctypes.c_longlong, _P,
    ),
    # device, plan, o_re, o_im, u_re, u_im, work, work values, stream
    "lmvn_fused_pass_bf": (ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P),
    # device, plan, out, t_re, t_im, v_re, v_im, work, work values, stream
    "lmvn_fused_pass_c": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P),
    # device, plan, out, u_re, u_im, t_re, t_im, v_re, v_im, psi, w, w_scalar,
    # lam, min_value, work, work values, stream
    "lmvn_fused_pass_cua": (
        ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, _P, ctypes.c_longlong, _P,
    ),
}
# each fused pass's bf16-spectrum twin takes the arguments of its f32 entry
_SIGNATURES.update({
    f"{name}_bf16": argtypes for name, argtypes in _SIGNATURES.items()
    if name.startswith("lmvn_fused_")
})

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest() -> str:
    """A hash of the flags, each unit's source and flags, and the sources'
    and headers' contents."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(repr(_UNITS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  One ``nvcc -c`` per unit runs at the same time,
    then one link.  nvcc's report (``-Xptxas -v``: registers, spills) is
    kept beside the library as ``nvcc.log``.  Raises with nvcc's stderr on a
    failed build."""
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / "liblmvn_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build the CUDA kernels")
    out_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [out_dir / f".{stem}.{pid}.o" for _, _, stem in _UNITS]
    cmds = [
        [nvcc, *_FLAGS, *flags, "-c", "-o", str(o), str(_CSRC / s)]
        for (s, flags, _), o in zip(_UNITS, objs)
    ]
    tmp = out_dir / f".liblmvn_kernels.{pid}.so"
    cmds_link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    log = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()
            log.append(out + err)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}"
                )
        proc = subprocess.run(cmds_link, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmds_link)}\n{proc.stderr}"
            )
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    (out_dir / "nvcc.log").write_text("".join(log))
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use.  Raises when CUDA is
    not available: there is nothing to launch on."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: the hand-written kernels need an "
                    "NVIDIA GPU (CPU tensors use the plain versions)"
                )
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.lmvn_error_string.argtypes = [ctypes.c_int]
            lib.lmvn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if err != 0:
        what = library().lmvn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what}) at launch")
