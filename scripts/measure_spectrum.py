#!/usr/bin/env python3
"""The fused engine's per-call spectrum forwarding alone, on one NVIDIA GPU.

Run from the repository root on a host with one GPU:

    python3 scripts/measure_spectrum.py [--root DIR] [--label NAME] [--n 256] [--adjoint]

``--root`` imports ``libmultiviewnative_torch`` from another checkout (an
unpacked ``git archive`` of a parent commit), so two trees can be measured in
one process each, in turns, on the same card.  At the benchmark's kernels (4
views, Gaussian kernel1 21³ with sigma 2.0 + 0.5 v, kernel2 the flipped
kernel1 padded to 25³) and n³ volumes, it forwards the kernel stacks of one
``deconvolve`` call (``deconv.rl._forward_spectra``: kernel1 and kernel2, or
kernel1 alone with ``--adjoint``) and reports:

* the host ms of a forwarding that ends in a synchronise, and its device ms
  (CUDA events round it), medians of 20 in two turns of 10;
* one forwarding traced with ``torch.profiler``: its device events (kernels,
  copies, fills) by name, their count and summed device time, which is what
  the benchmark's ``launches_per_stack`` and ``forward_ms_per_stack`` count.

The card's name and power limit come first, one JSON line last.
"""

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--adjoint", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from libmultiviewnative_torch.deconv import rl
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    if not torch.cuda.is_available():
        raise SystemExit("measure_spectrum: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    import libmultiviewnative_torch

    print(f"{args.label}: package from {os.path.dirname(libmultiviewnative_torch.__file__)}",
          flush=True)
    dev = torch.device("cuda", 0)
    shape = (args.n,) * 3
    k1 = np.stack([gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)])
    k2 = k1 if args.adjoint else np.stack([np.pad(np.flip(k), 2) for k in k1])
    # the forwarding reads the kernels and the views' device; a small view
    # stack keeps the card's memory for the spectra
    data = MultiViewData(torch.ones((V, 8, 8, 8), device=dev), torch.from_numpy(k1).to(dev),
                         torch.from_numpy(k2).to(dev), torch.full((V,), 1.0 / V, device=dev))

    def forward():
        return rl._forward_spectra("fused", data, shape, args.adjoint)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(2):
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            forward()
            end.record()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
            device.append(start.elapsed_time(end))
        torch.cuda.empty_cache()
    what = f"{V} views {args.n}^3{' adjoint' if args.adjoint else ''}"
    print(f"{args.label}: forwarding of one call at {what}: host ms median"
          f" {statistics.median(host):.4f} (best {min(host):.4f}), stream ms median"
          f" {statistics.median(device):.4f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter(e.name[:80] for e in events)
    busy_ms = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    print(f"{args.label}: one forwarding traced: {len(events)} device events, {busy_ms:.4f} ms",
          flush=True)
    for name, count in by_name.most_common():
        print(f"  {count:4d} {name}", flush=True)
    print(json.dumps({"label": args.label, "card": card, "n": args.n, "adjoint": args.adjoint,
                      "host_ms": host, "stream_ms": device,
                      "host_ms_median": statistics.median(host),
                      "stream_ms_median": statistics.median(device),
                      "device_events": len(events), "traced_device_ms": busy_ms}), flush=True)


if __name__ == "__main__":
    main()
