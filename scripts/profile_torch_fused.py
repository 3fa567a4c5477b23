#!/usr/bin/env python3
"""Where one call of the port's engine spends its device time on an NVIDIA GPU.

Run from the repository root on a host with one GPU:

    python3 scripts/profile_torch_fused.py [--n 256] [--algorithm fused]
        [--carried | --interleaved]

Drives bench.py's headline configuration (4 views at n³, kernel1 21³,
kernel2 25³, per-voxel weights, λ 0.006, 10 iterations) once to warm up,
then once under ``torch.profiler``.  ``--carried`` runs the fused engine's
carried chain (``LMVN_FUSED_CARRY=1``).  ``--interleaved`` runs the
interleaved rung instead, in benchmarks/bench_streamed.py's configuration
(kernel2 the flipped 21³ kernel1, chunk_z 64, 2 iterations, the host stacks
pinned beforehand).  It prints:

* device time by pass (the seven fused passes, spectrum prep): each pass
  wrapper runs inside a ``record_function`` range here, so the kernels it
  launches are summed under its name;
* device time by kernel name, with the count; host-to-device copies appear
  as ``Memcpy HtoD`` events;
* the idle share: 1 - (union of kernel and copy intervals) / (host wall time
  of the synchronised call), and the same for the kernels alone.

The card's name and power limit come first, from nvidia-smi.  The profiled
call is not timed for throughput: chip_smoke.py does that.
"""

import argparse
import functools
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PASSES = ("pass_a", "pass_bf", "pass_b", "pass_c", "pass_cqa", "pass_cu", "pass_cua")


def busy_ms(events):
    """Length of the union of [start, end) device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # µs -> ms


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import ITERS, LAM, MIN_VALUE, V, bench_kernels
    from libmultiviewnative_torch.deconv import interleaved as il, rl
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.ops import fused as fu

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--algorithm", default="fused", choices=("fused", "fft"))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--carried", action="store_true")
    mode.add_argument("--interleaved", action="store_true")
    args = ap.parse_args()
    if args.carried:
        os.environ["LMVN_FUSED_CARRY"] = "1"
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_fused: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    for name in PASSES:  # name each pass's kernels after the pass
        fn = getattr(fu, name)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)

        setattr(fu, name, wrapped)
    owner, prep = (
        (il, il.engine_spectra) if args.interleaved
        else (rl, rl.prepare_spectra_fused if args.algorithm == "fused" else rl.prepare_spectra)
    )

    @functools.wraps(prep)
    def prep_wrapped(*a, **k):
        with record_function("spectrum_prep"):
            return prep(*a, **k)

    setattr(owner, prep.__name__, prep_wrapped)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    shape = (args.n,) * 3
    k1, k2 = bench_kernels()
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    if args.interleaved:
        host_views = [torch.from_numpy(v).pin_memory() for v in views]
        host_weights = [torch.full(shape, 1.0 / V).pin_memory() for _ in range(V)]
        k2 = np.stack([np.flip(k).copy() for k in k1])
        psi0 = np.full(shape, float(views[0].mean()), np.float32)
        iters = 2

        def call():
            return il.deconvolve_interleaved(psi0, host_views, k1, k2, host_weights, iters,
                                             lam=LAM, min_value=MIN_VALUE,
                                             algorithm=args.algorithm, device=dev)
    else:
        views = torch.from_numpy(views).to(dev)
        data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                             torch.full((V,) + shape, 1.0 / V, device=dev))
        psi0 = torch.full(shape, float(views.mean()), device=dev)
        iters = ITERS

        def call():
            return rl.deconvolve(psi0, data, ITERS, lam=LAM, min_value=MIN_VALUE,
                                 algorithm=args.algorithm)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = PASSES + ("spectrum_prep",)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # the record_function ranges appear on the device too, as annotations
    kernels = [e for e in device if e.name not in ranges]
    busy = busy_ms(kernels)
    compute_busy = busy_ms([e for e in kernels if not e.name.startswith("Memcpy")])
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    what = ("interleaved " if args.interleaved else "") + args.algorithm
    what += " carried" if args.carried else ""
    print(f"{what} 4 views {args.n}^3, {iters} iterations: wall {wall_ms:.3f} ms,"
          f" device time {total:.3f} ms, busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f};"
          f" kernels alone busy {compute_busy:.3f} ms, idle share {1 - compute_busy / wall_ms:.4f}")
    print("by pass (device ms of the kernels each range launched, calls; the 8 pass_a"
          " calls of the spectrum prep count under both):")
    for name in ranges:
        spans = [e for e in device if e.name == name]
        inside = [k for k in kernels
                  if any(s.time_range.start <= k.time_range.start < s.time_range.end
                         for s in spans)]
        ms = sum(k.time_range.elapsed_us() for k in inside) / 1e3
        print(f"  {name:14s} {ms:10.3f} ms  x{len(spans)}")
    print("by kernel (device ms, count, share of kernel time):")
    by = {}
    for e in kernels:
        ms, n = by.get(e.name, (0.0, 0))
        by[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} ms  x{n:4d}  {100 * ms / total:5.1f} %  {name[:110]}")


if __name__ == "__main__":
    main()
