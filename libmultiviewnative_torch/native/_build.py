"""Build the port's C ABI library and its C host smoke with ``g++``.

At first use, ``bridge.cpp`` (against the header copy beside it) is compiled
into ``build/torch_native/<hash>/libmultiviewnative_torch.so`` beside the
package (a directory ``.gitignore`` lists), keyed by a hash of the sources,
the flags and the interpreter's build, as ``ops/_build.py`` does for the
kernels.  Each build writes a temporary file and renames it into place, so
concurrent builders (test workers) never see half a library.

The Python flags come from ``sysconfig`` (``python3-config`` may be
missing).  The library links libpython only where the interpreter has a
shared one (``Py_ENABLE_SHARED``): loaded into a Python process with
ctypes, it needs no link, because the symbols come from the running
interpreter; a pure C host needs the link, so :func:`build_smoke` refuses
on an interpreter without a shared libpython.  That decision rests on the
interpreter's build, never on a failure caught.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import List

_SRC = Path(__file__).resolve().parent
_SOURCES = ("bridge.cpp", "multiviewnative_tpu.h", "abi_smoke.c")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_LIB_NAME = "multiviewnative_torch"
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")


def python_flags() -> dict:
    """The interpreter's include directory, library directory and library,
    and whether that library is shared, from ``sysconfig``."""
    var = sysconfig.get_config_var
    ldlibrary = var("LDLIBRARY") or ""
    return {
        "include": var("INCLUDEPY"),
        "libdir": var("LIBDIR"),
        "ldlibrary": ldlibrary,
        "shared": bool(var("Py_ENABLE_SHARED")) and ldlibrary.endswith(".so"),
    }


def _link_python(flags: dict) -> List[str]:
    """g++ arguments that link the interpreter's shared libpython."""
    name = flags["ldlibrary"][len("lib"):-len(".so")]
    return [f"-L{flags['libdir']}", f"-l{name}", f"-Wl,-rpath,{flags['libdir']}"]


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: cannot build the C ABI library")
    return cxx


def _out_dir(flags: dict) -> Path:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    h.update(repr(sorted(flags.items())).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_SRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _compile(cmd: List[str], target: Path, tmp: Path) -> Path:
    """Run one g++ command that writes ``tmp``, then move it to ``target``."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    return target


def build(force: bool = False) -> Path:
    """Compile ``libmultiviewnative_torch.so`` if this source hash has none
    yet, or anew with ``force``; return its path.  Raises with g++'s stderr
    on a failed build."""
    flags = python_flags()
    out_dir = _out_dir(flags)
    lib = out_dir / f"lib{_LIB_NAME}.so"
    if lib.exists() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{_LIB_NAME}.{os.getpid()}.so"
    cmd = [_cxx(), *_CXXFLAGS, f"-I{flags['include']}", f"-I{_SRC}", "-shared",
           "-o", str(tmp), str(_SRC / "bridge.cpp")]
    if flags["shared"]:
        cmd += _link_python(flags)
    return _compile(cmd, lib, tmp)


def build_smoke() -> Path:
    """Compile the C host smoke (``abi_smoke.c``) against the library; return
    the executable's path.  Raises ``RuntimeError`` where the interpreter
    has no shared libpython: a C host cannot embed it then."""
    flags = python_flags()
    if not flags["shared"]:
        raise RuntimeError(
            "this interpreter has no shared libpython (Py_ENABLE_SHARED is off): "
            "a pure C host cannot embed it"
        )
    lib = build()
    exe = lib.parent / "abi_smoke"
    if exe.exists():
        return exe
    tmp = lib.parent / f".abi_smoke.{os.getpid()}"
    cmd = [_cxx(), "-O2", f"-I{_SRC}", "-o", str(tmp), str(_SRC / "abi_smoke.c"),
           f"-L{lib.parent}", f"-l{_LIB_NAME}", f"-Wl,-rpath,{lib.parent}",
           *_link_python(flags), "-lm"]
    return _compile(cmd, exe, tmp)


def smoke_env(repo_root: str, sys_path: List[str]) -> dict:
    """The environment for the C host: ``PYTHONPATH`` at the repo root, then
    the running interpreter's own path (its standard library and
    site-packages, wherever torch is installed)."""
    path = os.pathsep.join([repo_root] + [p for p in sys_path if p])
    return dict(os.environ, PYTHONPATH=path)
