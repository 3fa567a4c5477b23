#!/usr/bin/env python3
"""The port's two engines against each other on one NVIDIA GPU, in turns:
the fft engine, the fused engine's plain chain and its carried chain
(``LMVN_FUSED_CARRY=1``), at bench.py's configurations and the thin shape
of chip_smoke.py phase 17.

Run from the repository root on a host with one GPU:

    python3 scripts/measure_engines.py

For each configuration (4 views at 256³ with per-voxel weights, the same
through ``prepare_workspace`` + ``deconvolve_prepared``, 512³ with
``adjoint_kernel2`` and scalar weights, and (32, 512, 512), where both bench
kernels take the dense forwarding) it runs the engines in the order fft,
fused, carried, carried, fused, fft, each time measuring bench.py's two
numbers as chip_smoke.py does (``rate``: 10 iterations over the best of
several calls, and the slope with the per-call constants cancelled).  It
also times the per-call spectrum forwarding of each engine alone (both
kernel stacks, host clock around a synchronised call, best of 10 in two turns).
It prints the card's name and power limit first and one JSON line last:
per configuration and engine, the median of its two turns.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENGINES = ("fft", "fused", "carried")


def main():
    import numpy as np
    import torch

    from chip_smoke import LAM, MIN_VALUE, THIN_SHAPE, big_data, headline_data, rate, thin_data
    from libmultiviewnative_torch.deconv import rl

    if not torch.cuda.is_available():
        raise SystemExit("measure_engines: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def set_carry(engine):
        os.environ["LMVN_FUSED_CARRY"] = "1" if engine == "carried" else "0"
        return "fft" if engine == "fft" else "fused"

    results, prep = {}, {}
    for label, make, kw, reps, prepared in (
        ("256^3", headline_data, {}, 4, False),
        ("256^3 prepared", headline_data, {}, 4, True),
        ("512^3 adjoint", big_data, {"adjoint_kernel2": True}, 2, False),
        (f"{THIN_SHAPE}", thin_data, {}, 4, False),
    ):
        data, psi0 = make(torch, dev, rng)
        shape = tuple(psi0.shape)
        spectra = {}
        if prepared:
            for algorithm in ("fft", "fused"):
                spectra[algorithm] = rl.prepare_workspace(data, shape, algorithm=algorithm)
        turns = {engine: [] for engine in ENGINES}
        for engine in ENGINES + ENGINES[::-1]:
            algorithm = set_carry(engine)

            def run_n(n, algorithm=algorithm):
                if prepared:
                    return rl.deconvolve_prepared(psi0, data, spectra[algorithm], n, lam=LAM,
                                                  min_value=MIN_VALUE)
                return rl.deconvolve(psi0, data, n, lam=LAM, min_value=MIN_VALUE,
                                     algorithm=algorithm, **kw)

            turns[engine].append(rate(torch, run_n, reps))
            print(f"{label} {engine}: {turns[engine][-1][0]!r} it/s, slope {turns[engine][-1][1]!r}",
                  flush=True)
        results[label] = {
            engine: {"it_s": statistics.median(t[0] for t in ts),
                     "slope": statistics.median(t[1] for t in ts)}
            for engine, ts in turns.items()
        }
        if label in ("256^3", "512^3 adjoint"):
            times = {"fft": [], "fused": []}
            for algorithm in ("fft", "fused", "fused", "fft"):
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rl.prepare_workspace(data, shape, algorithm=algorithm, adjoint_kernel2=bool(kw))
                    torch.cuda.synchronize()
                    times[algorithm].append(1e3 * (time.perf_counter() - t0))
            prep[label] = {algorithm: min(t) for algorithm, t in times.items()}
            print(f"{label} spectrum forwarding per call, ms (best of 10): {prep[label]}",
                  flush=True)
        del data, psi0, spectra
        torch.cuda.empty_cache()
    os.environ.pop("LMVN_FUSED_CARRY", None)
    for label, by in results.items():
        line = ", ".join(f"{e} {v['it_s']:.2f} it/s (slope {v['slope']:.2f})" for e, v in by.items())
        print(f"{label}: {line}", flush=True)
    print(json.dumps({"engines": results, "spectrum_forwarding_ms": prep}), flush=True)


if __name__ == "__main__":
    main()
