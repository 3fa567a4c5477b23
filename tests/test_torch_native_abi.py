"""The port's C ABI library (``libmultiviewnative_torch/native/``) through
ctypes and from a pure C host: the cases of tests/test_native_abi.py, the
device semantics of the GPU-named symbols, and the header against the JAX
build's.

Parity: the cpu-named symbols bitwise equal the port's flat API on the CPU
(the bridge only wraps the caller's buffers), and the deconvolution within
1e-4 of max|psi| of JAX's (test_torch_rl.py's RTOL), the convolution within
1e-5 of max.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu import api as japi
from libmultiviewnative_torch import api, native_client
from libmultiviewnative_torch.native import _build
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HEADERS = (REPO / "native" / "include" / "multiviewnative_tpu.h",
           REPO / "libmultiviewnative_torch" / "native" / "multiviewnative_tpu.h")

if shutil.which("g++") is None:
    pytest.skip("no g++ toolchain", allow_module_level=True)


@pytest.fixture(scope="module")
def lib():
    return native_client.load_native()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _declared(header: Path) -> set:
    return set(re.findall(r"MVN_API\s+[\w\s\*]*?\b(\w+)\s*\(", header.read_text()))


def test_headers_declare_the_same_functions():
    jax_names, port_names = (_declared(h) for h in HEADERS)
    assert len(jax_names) == 19 and port_names == jax_names


def test_library_exports_exactly_the_header(lib):
    names = _declared(HEADERS[1])
    for name in names:
        assert hasattr(lib, name), name
    if shutil.which("nm") is None:
        return
    nm = subprocess.run(["nm", "-D", "--defined-only", native_client.build_native()],
                        capture_output=True, text=True, check=True).stdout
    exported = {line.split()[-1] for line in nm.splitlines() if line.split()[1:2] == ["T"]}
    assert {n for n in exported if not n.startswith("_")} == names


def test_device_queries(lib):
    n = torch.cuda.device_count()
    assert lib.getNumDevicesCUDA() == n  # 0 on a host without a card
    buf = ctypes.create_string_buffer(256)
    lib.getNameDeviceCUDA(0, buf)
    if n == 0:
        assert buf.value == b""
        assert b"no CUDA device" in lib.mvn_tpu_last_error()
        assert lib.getMemDeviceCUDA(0) == 0
        assert lib.getCUDAcomputeCapabilityMajorVersion(0) == 0
        assert lib.selectDeviceWithHighestComputeCapability() == 0
        return
    assert buf.value.decode() == torch.cuda.get_device_name(0)
    assert lib.getMemDeviceCUDA(0) == torch.cuda.get_device_properties(0).total_memory
    assert (lib.getCUDAcomputeCapabilityMajorVersion(0),
            lib.getCUDAcomputeCapabilityMinorVersion(0)) == torch.cuda.get_device_capability(0)
    assert lib.selectDeviceWithHighestComputeCapability() == api.select_device()


def test_convolution_parity_and_inplace(lib):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(8, 8, 8)).astype(np.float32)
    k = gaussian_kernel((3, 3, 3), 1.0)
    buf = img.copy()
    out = native_client.native_convolution(lib, buf, k, device="cpu")
    assert out is buf  # written in place, in the caller's memory
    np.testing.assert_array_equal(out, api.convolution3d(img, k, device="cpu"))
    assert _rel(out, japi.convolution3d(img, k)) <= 1e-5


def test_deconvolve_parity(lib):
    rng = np.random.default_rng(2)
    imgs = [rng.gamma(2.0, 20.0, (10, 10, 10)).astype(np.float32) for _ in range(2)]
    k1s = [gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(2)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [np.full((10, 10, 10), 0.5, np.float32) for _ in range(2)]
    psi0 = np.full((10, 10, 10), float(np.mean(imgs)), np.float32)

    nw = native_client.NativeWorkspace(imgs, k1s, k2s, ws, lambda_=0.006, num_iterations=2)
    got = native_client.native_deconvolve(lib, psi0.copy(), nw, device="cpu")
    want = api.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.006,
                               device="cpu")
    np.testing.assert_array_equal(got, want)
    jax_want = japi.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.006)
    assert _rel(got, jax_want) <= 1e-4


GPU_SYMBOLS = ("inplace_gpu_deconvolve", "inplace_gpu_convolution",
               "convolution3DfftCUDAInPlace", "convolution3DfftCUDAInPlace_core",
               "compute_quotient", "compute_final_values", "iterate_fft_plain",
               "iterate_fft_tikhonov")


@pytest.mark.parametrize("symbol", GPU_SYMBOLS)
def test_gpu_symbol_without_the_card_leaves_buffers_untouched(lib, symbol):
    """A GPU-named symbol asked for a card this host does not have (index
    device_count(): 0 here) records the error and writes nothing; it never
    computes on the CPU instead."""
    missing = torch.cuda.device_count()
    rng = np.random.default_rng(3)
    shape = (6, 6, 6)
    bufs = [rng.gamma(2.0, 5.0, shape).astype(np.float32) for _ in range(4)]
    kernel = gaussian_kernel((3, 3, 3), 1.0)
    before = [b.copy() for b in bufs] + [kernel.copy()]
    f = native_client._fptr
    dims, kdims = (ctypes.c_int * 3)(*shape), (ctypes.c_int * 3)(*kernel.shape)
    n = bufs[0].size
    nw = native_client.NativeWorkspace(bufs[1:2], [kernel], [kernel], bufs[2:3],
                                       lambda_=0.006, num_iterations=1)
    call = {
        "inplace_gpu_deconvolve": lambda: lib.inplace_gpu_deconvolve(f(bufs[0]), nw.struct,
                                                                     missing),
        "inplace_gpu_convolution": lambda: lib.inplace_gpu_convolution(
            f(bufs[0]), dims, f(kernel), kdims, missing),
        "convolution3DfftCUDAInPlace": lambda: lib.convolution3DfftCUDAInPlace(
            f(bufs[0]), dims, f(kernel), kdims, missing),
        "convolution3DfftCUDAInPlace_core": lambda: lib.convolution3DfftCUDAInPlace_core(
            f(bufs[0]), dims, f(kernel), kdims, missing),
        "compute_quotient": lambda: lib.compute_quotient(f(bufs[0]), f(bufs[1]), n, missing),
        "compute_final_values": lambda: lib.compute_final_values(
            f(bufs[0]), f(bufs[1]), f(bufs[2]), n, 1e-4, 0.006, missing),
        "iterate_fft_plain": lambda: lib.iterate_fft_plain(
            f(bufs[0]), f(kernel), f(bufs[3]), dims, kdims, missing),
        "iterate_fft_tikhonov": lambda: lib.iterate_fft_tikhonov(
            f(bufs[0]), f(kernel), f(bufs[3]), dims, kdims, n, 1e-4, 0.006, missing),
    }[symbol]
    call()
    assert f"no CUDA device 'cuda:{missing}'".encode() in lib.mvn_tpu_last_error()
    for b, want in zip(bufs + [kernel], before):
        np.testing.assert_array_equal(b, want)


def test_c_host_smoke():
    """The JNA scenario: a pure C executable boots the embedded interpreter
    and runs the pipeline through the cpu-named symbols; with --gpu it needs
    a card and fails without one."""
    if not _build.python_flags()["shared"]:
        pytest.skip("this interpreter has no shared libpython: a C host cannot embed it")
    exe = _build.build_smoke()
    env = _build.smoke_env(str(REPO), sys.path)
    res = subprocess.run([str(exe)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
    assert "finite=1" in res.stdout and "changed=1" in res.stdout
    if torch.cuda.device_count() == 0:
        res = subprocess.run([str(exe), "--gpu"], env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
