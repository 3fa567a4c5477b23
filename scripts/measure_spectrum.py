#!/usr/bin/env python3
"""The fused engine's per-call spectrum forwarding alone, on one NVIDIA GPU.

Run from the repository root on a host with one GPU:

    python3 scripts/measure_spectrum.py [--root DIR] [--label NAME]

``--root`` imports ``libmultiviewnative_torch`` from another checkout (an
unpacked ``git archive`` of a parent commit), so two trees can be measured in
one process each, in turns, on the same card.  At chip_smoke.py's headline
(4 views at 256³, the bench kernels 21³ and 25³) it times
``prepare_workspace`` of the fused and the fft engine (the 8 spectra a
``deconvolve`` call forwards), host clock around a synchronised call, best of
10 in two turns, then traces one fused forwarding with ``torch.profiler``
and prints the top operations by host and by device time.  The card's name
and power limit come first, one JSON line last.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from libmultiviewnative_torch.deconv import rl
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    if not torch.cuda.is_available():
        raise SystemExit("measure_spectrum: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    import libmultiviewnative_torch

    print(f"{args.label}: package from {os.path.dirname(libmultiviewnative_torch.__file__)}",
          flush=True)
    dev = torch.device("cuda", 0)
    V, n = 4, 256
    shape = (n,) * 3
    k1 = np.stack([gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)])
    k2 = np.stack([np.pad(np.flip(k), 2) for k in k1])  # the flipped kernel padded to 25³
    views = torch.ones((V,) + shape, device=dev)
    data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                         torch.full((V,), 1.0 / V, device=dev))

    times = {"fused": [], "fft": []}
    for engine in ("fused", "fft"):
        rl.prepare_workspace(data, shape, algorithm=engine)  # warm-up
    for engine in ("fused", "fft", "fft", "fused"):
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rl.prepare_workspace(data, shape, algorithm=engine)
            torch.cuda.synchronize()
            times[engine].append(1e3 * (time.perf_counter() - t0))
    best = {engine: min(t) for engine, t in times.items()}
    print(f"{args.label}: spectrum forwarding per call at 4 views {n}^3, ms (best of 10): {best}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rl.prepare_workspace(data, shape, algorithm="fused")
        torch.cuda.synchronize()
    table = prof.key_averages()
    for key in ("cpu_time_total", "device_time_total"):
        print(f"{args.label}: one fused forwarding, top by {key}", flush=True)
        print(table.table(sort_by=key, row_limit=12), flush=True)
    device_ms = sum(e.self_device_time_total for e in table) / 1e3
    print(json.dumps({"label": args.label, "forwarding_ms": best, "times_ms": times,
                      "traced_device_ms": device_ms}), flush=True)


if __name__ == "__main__":
    main()
