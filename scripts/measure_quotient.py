#!/usr/bin/env python3
"""K2 (the quotient, view · (1/integral)) launched several ways, timed in
turns against ``torch.div`` on an NVIDIA GPU.

Run from the repository root on a host with one GPU:

    python3 scripts/measure_quotient.py [--sizes 256 512] [--launches 20]

It builds the variants below with ``nvcc`` (the library's flags, into
``build/measure_quotient/``), each computing ``lmvn::quotient_one`` of
``ops/csrc/rl_update.cuh`` on 16-byte vectors:

* ``strided1 cap``: a grid-stride loop, one vector of each operand a
  thread per step, the grid capped at 8192 blocks of 256 threads (the
  library's launch before it got its own);
* ``strided{1,2,4} waves``: the same loop with 1, 2 or 4 vectors of each
  operand loaded before the first store, the grid one whole wave of the
  card (SMs × resident blocks, from the occupancy API);
* ``tiled{1,2,4}``: no loop, each block one tile of 256 × B vectors, the
  grid as many tiles as the volume needs;

and times each, the library's ``lmvn_quotient`` and ``torch.div`` at n³,
median CUDA-event ms of ``--launches`` launches, in turns (the list forward,
then backward, twice).  Every variant's output must equal
``quotient_plain`` bitwise.  It prints the card's name and power limit
first and one JSON line last.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stddef.h>
#include "rl_update.cuh"

namespace {
constexpr int kThreads = 256;

__device__ __forceinline__ float4 q4(float4 v, float4 d) {
  return make_float4(lmvn::quotient_one(v.x, d.x), lmvn::quotient_one(v.y, d.y),
                     lmvn::quotient_one(v.z, d.z), lmvn::quotient_one(v.w, d.w));
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    strided(float4* out, const float4* view, const float4* d, size_t n4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i0 < n4;
       i0 += B * stride) {
    float4 v[B], w[B];
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (i0 + b * stride < n4) {
        v[b] = view[i0 + b * stride];
        w[b] = d[i0 + b * stride];
      }
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (i0 + b * stride < n4) out[i0 + b * stride] = q4(v[b], w[b]);
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    tiled(float4* out, const float4* view, const float4* d, size_t n4) {
  const size_t i0 = static_cast<size_t>(blockIdx.x) * kThreads * B + threadIdx.x;
  float4 v[B], w[B];
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (i0 + b * kThreads < n4) {
      v[b] = view[i0 + b * kThreads];
      w[b] = d[i0 + b * kThreads];
    }
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (i0 + b * kThreads < n4) out[i0 + b * kThreads] = q4(v[b], w[b]);
}

template <class K>
unsigned wave(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return static_cast<unsigned>(sms * per_sm);
}

unsigned cdiv(size_t a, size_t b) { return static_cast<unsigned>((a + b - 1) / b); }
}  // namespace

extern "C" int variant_quotient(int variant, void* out, const void* view, const void* d,
                                long long n4, void* stream) {
  auto o = static_cast<float4*>(out);
  auto v = static_cast<const float4*>(view);
  auto w = static_cast<const float4*>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t n = static_cast<size_t>(n4);
  unsigned capped = cdiv(n, kThreads) < 8192 ? cdiv(n, kThreads) : 8192;
  switch (variant) {
    case 0: strided<1><<<capped, kThreads, 0, s>>>(o, v, w, n); break;
    case 1: strided<1><<<wave(strided<1>), kThreads, 0, s>>>(o, v, w, n); break;
    case 2: strided<2><<<wave(strided<2>), kThreads, 0, s>>>(o, v, w, n); break;
    case 3: strided<4><<<wave(strided<4>), kThreads, 0, s>>>(o, v, w, n); break;
    case 4: tiled<1><<<cdiv(n, kThreads), kThreads, 0, s>>>(o, v, w, n); break;
    case 5: tiled<2><<<cdiv(n, 2 * kThreads), kThreads, 0, s>>>(o, v, w, n); break;
    case 6: tiled<4><<<cdiv(n, 4 * kThreads), kThreads, 0, s>>>(o, v, w, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
VARIANTS = ("strided1 cap", "strided1 waves", "strided2 waves", "strided4 waves",
            "tiled1", "tiled2", "tiled4")


def build():
    from libmultiviewnative_torch.ops import _build

    out = ROOT / "build" / "measure_quotient"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "variants.cu"
    src.write_text(SOURCE)
    lib = out / "libvariants.so"
    flags = [f for f in _build._FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run(["nvcc", *flags, "-shared", "-I", str(_build._CSRC), "-o", str(lib), str(src)],
                   check=True, timeout=600)
    so = ctypes.CDLL(str(lib))
    so.variant_quotient.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
    so.variant_quotient.restype = ctypes.c_int
    return so


def main():
    import torch

    from libmultiviewnative_torch.ops import elementwise as ew

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_quotient: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    so = build()
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def times(fn):
        fn()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(args.launches)]
        for a, b in ev:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in ev]

    result = {}
    for n in args.sizes:
        gen = torch.Generator(device=dev).manual_seed(n)
        view = torch.rand((n,) * 3, generator=gen, device=dev) * 200.0
        denom = torch.rand((n,) * 3, generator=gen, device=dev) + 0.5
        out = torch.empty_like(view)
        want = ew.quotient_plain(view, denom)
        fns = {"torch.div": lambda: torch.div(view, denom),
               "lmvn_quotient": lambda: ew.quotient(view, denom, out=out)}
        for i, name in enumerate(VARIANTS):
            def run(i=i):
                err = so.variant_quotient(i, out.data_ptr(), view.data_ptr(), denom.data_ptr(),
                                          view.numel() // 4, stream())
                if err:
                    raise RuntimeError(f"variant {i}: CUDA error {err}")
            fns[name] = run
        for name, fn in fns.items():
            if name == "torch.div":
                continue
            out.zero_()
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} at {n}^3 differs from quotient_plain")
        samples = {name: [] for name in fns}
        order = list(fns)
        for turn in (order, order[::-1], order, order[::-1]):
            for name in turn:
                samples[name] += times(fns[name])
        ms = {name: statistics.median(s) for name, s in samples.items()}
        nbytes = 3 * view.numel() * 4
        for name, t in ms.items():
            print(f"{n}^3 {name:16s} {t:.4f} ms {nbytes / t / 1e6:8.1f} GB/s"
                  f" ({100 * (t / ms['torch.div'] - 1):+.1f} % against torch.div)", flush=True)
        result[str(n)] = ms
        del view, denom, out, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "quotient_ms": result}), flush=True)


if __name__ == "__main__":
    main()
