#!/usr/bin/env python3
"""The fft engine's two routes of one convolution against each other on one
NVIDIA GPU: the 3D route (``rfftn``, K3, ``irfftn`` with its 1/N pass) and the
hand route (cuFFT on x and y, the hand-written z pass, ``ops/z_convolve.py``).

Run from the repository root on a host with one GPU:

    python3 scripts/measure_z_pass.py [--planes 1024 512] [--z 64 128 256 280 300 512 1024]

For each plane (Y = X) and depth Z it forwards a Gaussian 21³ kernel (σ 2)
as the engine does (``rfft3`` of the wrapped kernel) and times, with CUDA
events, in the turns 3D, hand, hand, 3D (``--reps`` calls a turn): one
``convolve_spectrum`` on each route, and the hand route's parts alone: the
x r2c and y c2c forward, the z pass (``z_convolve``) with its byte bound
(the spectrum read and written and the kernel spectrum read, 24 B a complex
value, over 3.35 TB/s), the inverse y c2c and x c2r.  It checks the two
routes against each other (max|diff| / max) and counts the launches of one
call of each under ``torch.profiler``.  It prints the card's name and power
limit first and one JSON line last: per shape, the medians in ms.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12


def events_ms(torch, fn, n):
    """CUDA-event times (ms) of ``n`` calls after one warm-up."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(n)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def device_launches(torch, fn):
    """Device kernels and copies one call of ``fn`` runs."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def main():
    import torch

    from libmultiviewnative_torch.core import convolve as cv
    from libmultiviewnative_torch.core.fft import rfft3
    from libmultiviewnative_torch.core.wrap import wrap_kernel
    from libmultiviewnative_torch.ops import z_convolve as zc
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--planes", type=int, nargs="+", default=[1024, 512])
    ap.add_argument("--z", type=int, nargs="+", default=[64, 128, 256, 280, 300, 512, 1024])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_z_pass: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = torch.from_numpy(gaussian_kernel((21,) * 3, 2.0)).to(dev)
    results = {}
    for n in args.planes:
        for Z in args.z:
            shape = (Z, n, n)
            x = torch.rand(shape, generator=gen, device=dev)
            k = rfft3(wrap_kernel(kernel, shape))
            label = f"{shape}"
            if not zc.takes_z_pass(x, k):
                print(f"{label}: the hand route does not serve this shape", flush=True)
                continue
            plans = zc._plans_for(shape, dev)
            hand = lambda: zc.z_pass_convolve(x, k)  # noqa: E731
            cube = lambda: cv._fft3_convolve(x, k)  # noqa: E731
            a, b = hand(), cube()
            torch.cuda.synchronize()
            err = float((a - b).abs().max() / b.abs().max())
            del a, b
            spec = torch.empty_strided((Z, n, plans.kx), (n, 1, Z * n), dtype=torch.complex64,
                                       device=dev)
            area = torch.empty(max(plans.work, 1), dtype=torch.uint8, device=dev)
            out = torch.empty(shape, device=dev)
            parts = {
                "r2c": lambda: plans.run(0, x.data_ptr(), spec.data_ptr()),
                "c2c_forward": lambda: plans.run(1, spec.data_ptr(), spec.data_ptr(),
                                                 zc._CUFFT_FORWARD),
                "z_convolve": lambda: zc.z_convolve(spec, k, False, shape, plans),
                "c2c_inverse": lambda: plans.run(1, spec.data_ptr(), spec.data_ptr(),
                                                 zc._CUFFT_INVERSE),
                "c2r": lambda: plans.run(2, spec.data_ptr(), out.data_ptr()),
            }
            spec.copy_(torch.randn(spec.shape, dtype=torch.complex64, device=dev, generator=gen))
            times = {"3d": [], "hand": []}
            for which in ("3d", "hand", "hand", "3d"):
                times[which] += events_ms(torch, cube if which == "3d" else hand, args.reps)
            row = {name: statistics.median(t) for name, t in times.items()}
            plans.area = area.data_ptr()  # each hand call set its own
            for name, fn in parts.items():
                row[name] = statistics.median(events_ms(torch, fn, args.reps))
            row["z_convolve_bound"] = 1e3 * 24 * Z * n * plans.kx / HBM_BYTES_PER_S
            row["launches"] = {"3d": device_launches(torch, cube),
                               "hand": device_launches(torch, hand)}
            row["max_rel_diff"] = err
            row["cufft_work_bytes"] = plans.work
            results[label] = row
            print(f"{label}: 3D {row['3d']:.4f} ms, hand {row['hand']:.4f} ms"
                  f" ({row['3d'] / row['hand']:.2f}x); r2c {row['r2c']:.4f}, c2c"
                  f" {row['c2c_forward']:.4f}/{row['c2c_inverse']:.4f}, z pass"
                  f" {row['z_convolve']:.4f} (bound {row['z_convolve_bound']:.4f},"
                  f" {row['z_convolve_bound'] / row['z_convolve']:.0%}), c2r {row['c2r']:.4f};"
                  f" launches {row['launches']}; max|diff|/max {err:.2e};"
                  f" cuFFT work {plans.work} B", flush=True)
            del x, k, spec, area, out, parts, plans
            for p in zc._plans.values():
                p.destroy()
            zc._plans.clear()
            torch.cuda.empty_cache()
    print(json.dumps({"z_pass": results}), flush=True)


if __name__ == "__main__":
    main()
