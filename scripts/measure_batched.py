#!/usr/bin/env python3
"""A batch of volumes at the headline: the fft engine's per-entry transforms
against one batched cuFFT transform, on an NVIDIA GPU.

    PYTHONPATH=. python3 scripts/measure_batched.py [--n 256] [--batch 4]

4 views of gamma(2, 20) data at n³ with bench.py's kernels (21³, 25³),
per-voxel weights 1/V, λ 0.006, 10 iterations, psi0 the views' mean times
1 + 0.05 b for entry b.  ``deconvolve`` of the batch runs twice: with the
convolves as the port runs them (``core/convolve.py``: each entry's rfft and
irfft alone, one K3 launch for the batch) and with one batched rfft/irfft of
the whole batch.  Each entry is held against the single-volume fft call on
it (max|diff|/max|psi|, bitwise), and against the single fused call; then
volumes/s of each, in turns (per-entry, batched, single fft, single fused,
single fused, single fft, batched, per-entry), and the peak memory above the
inputs.  Prints the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libmultiviewnative_torch.core import convolve  # noqa: E402
from libmultiviewnative_torch.core.fft import irfft3, rfft3  # noqa: E402
from libmultiviewnative_torch.deconv import rl  # noqa: E402
from libmultiviewnative_torch.deconv.workspace import MultiViewData, pad_kernel_to  # noqa: E402
from libmultiviewnative_torch.ops.elementwise import layout_like, spectral_multiply  # noqa: E402
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel  # noqa: E402

V, LAM, MIN_VALUE, ITERS = 4, 0.006, 1e-4, 10


def batched_transforms(x, kernel_hat, conj_k):
    """The batch's convolve as one batched cuFFT rfft and irfft."""
    x_hat = layout_like(rfft3(x), kernel_hat)
    prod = spectral_multiply(x_hat, kernel_hat, conj_k=conj_k, out=x_hat)
    return irfft3(prod, x.shape[-3:])


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("measure_batched: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev, B, shape = torch.device("cuda", 0), args.batch, (args.n,) * 3
    rng = np.random.default_rng(0)
    k1 = np.stack([gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)])
    k2 = np.stack([pad_kernel_to(np.flip(k).copy(), (25,) * 3) for k in k1])
    views = torch.from_numpy(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)).to(dev)
    data = MultiViewData(views, torch.from_numpy(k1).to(dev), torch.from_numpy(k2).to(dev),
                         torch.full((V,) + shape, 1.0 / V, device=dev))
    psi0 = torch.stack([torch.full(shape, float(views.mean()) * (1.0 + 0.05 * b), device=dev)
                        for b in range(B)])
    kw = dict(lam=LAM, min_value=MIN_VALUE)
    variants = {"per-entry": convolve._convolve_entries, "batched": batched_transforms}

    def run(variant):
        convolve._convolve_entries = variants[variant]
        return rl.deconvolve(psi0, data, ITERS, algorithm="fft", **kw)

    def singles(algorithm):
        return [rl.deconvolve(psi0[b], data, ITERS, algorithm=algorithm, **kw) for b in range(B)]

    ref, fused = singles("fft"), singles("fused")
    for variant in variants:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = run(variant)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        rel = max(float((out[b] - ref[b]).abs().max()) / float(ref[b].abs().max())
                  for b in range(B))
        rel_f = max(float((out[b] - fused[b]).abs().max()) / float(fused[b].abs().max())
                    for b in range(B))
        bitwise = all(bool(torch.equal(out[b], ref[b])) for b in range(B))
        print(f"{variant}: worst entry vs its single fft call {rel:.3e} (bitwise {bitwise}),"
              f" vs its single fused call {rel_f:.3e}; peak above the inputs {peak:.3f} GiB",
              flush=True)
        del out
    calls = {"per-entry": lambda: run("per-entry"), "batched": lambda: run("batched"),
             "single fft": lambda: singles("fft"), "single fused": lambda: singles("fused")}
    vps = {}
    for turn in ("per-entry", "batched", "single fft", "single fused", "single fused",
                 "single fft", "batched", "per-entry"):
        _, sec = timed(calls[turn])
        vps.setdefault(turn, []).append(B / sec)
    convolve._convolve_entries = variants["per-entry"]
    print(f"volumes/s, {B} x {args.n}^3, {ITERS} iterations: {vps} ({card})", flush=True)


if __name__ == "__main__":
    main()
