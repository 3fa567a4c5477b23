#!/usr/bin/env python3
"""The four fused passes built on the x stage that starts from half spectra
(K7 pass C, K8 pass CQA, K9 pass CU, K10 pass CUA), in two trees of the
port, timed in turns on one NVIDIA GPU.

Run from the repository root on a host with one GPU:

    python3 scripts/measure_x_stage.py --other build/parent [--sizes 256 512]
        [--launches 20]

``--other`` is a second copy of the repository, for example a ``git archive``
of another commit unpacked into a directory ``.gitignore`` lists.  Each tree
runs in a process of its own, which builds that tree's kernels into its own
``build/`` and imports its own package, in the order other, this, this,
other.  A run holds each pass against its plain version once (1e-5 of
max|plain|, plus 4 ulp(1)/λ for psi') and times it at n³ on the main path's
operands (per-voxel weights at 256³, a scalar weight at 512³, λ 0.006, the
outputs written over the same buffers each call): the median CUDA-event ms
of ``--launches`` launches after one warm-up.  It prints the card's name and
power limit first, then each kernel's median over each tree's two runs and
their ratio, and one JSON line last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PASSES = ("pass_c", "pass_cqa", "pass_cu", "pass_cua")
LAM, MIN_VALUE = 0.006, 1e-4


def worker(root, sizes, launches):
    """Time the passes of the package in ``root``; one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from libmultiviewnative_torch.ops import fused as fu
    from libmultiviewnative_torch.ops.fused_plan import make_fused_plan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = float(np.finfo(np.float32).eps)

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def rel(got, want):
        if isinstance(got, tuple):
            got = torch.cat([g.flatten() for g in got])
            want = torch.cat([w.flatten() for w in want])
        return float((got - want).abs().max()) / float(want.abs().max())

    def median_ms(fn):
        fn()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(launches)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    ms, errs = {}, {}
    for n in sizes:
        Z = Y = X = n
        plan = make_fused_plan((Z, Y, X))
        c = fu.plan_tensors(plan, dev)
        psi, view = rand((Z, X, Y), 1.0, 100.0), rand((Z, X, Y), 1.0, 200.0)
        weights = rand((Z, X, Y), 0.0, 0.5) if n == sizes[0] else 0.25
        v = fu.pass_a_plain(rand((Z, X, Y), 0.5, 1.5), c)
        out, buf = torch.empty_like(psi), (torch.empty_like(v[0]), torch.empty_like(v[1]))
        calls = {
            "pass_c": (lambda: fu.pass_c(*v, plan), lambda: fu.pass_c_plain(*v, c)),
            "pass_cqa": (lambda: fu.pass_cqa(*v, view, plan, out=buf),
                         lambda: fu.pass_cqa_plain(*v, view, c)),
            "pass_cu": (lambda: fu.pass_cu(*v, psi, weights, plan, LAM, MIN_VALUE, out=out),
                        lambda: fu.pass_cu_plain(*v, psi, weights, c, LAM, MIN_VALUE)),
            "pass_cua": (
                lambda: fu.pass_cua(*v, psi, weights, plan, LAM, MIN_VALUE, out=out, u_out=buf),
                lambda: fu.pass_cua_plain(*v, psi, weights, c, LAM, MIN_VALUE)),
        }
        ms[n], errs[n] = {}, {}
        for name in PASSES:
            kernel, plain = calls[name]
            got, want = kernel(), plain()
            parts = list(zip(got, want)) if name == "pass_cua" else [(got, want)]
            for i, (g, w) in enumerate(parts):
                err = rel(g, w)
                errs[n][name] = max(errs[n].get(name, 0.0), err)
                # psi' at λ > 0: the Tikhonov slack of chip_smoke.py
                psi_out = i == 0 and name in ("pass_cu", "pass_cua")
                slack = 4 * eps / LAM / float(w.abs().max()) if psi_out else 0.0
                if err > 1e-5 + slack:
                    raise AssertionError(f"{root}: {name} at {n}^3 off its plain version")
            del got, want, parts
            ms[n][name] = median_ms(kernel)
        del psi, view, weights, v, out, buf
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "ms": ms, "max_rel_err": errs}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.sizes, args.launches)
    if args.other is None:
        raise SystemExit("measure_x_stage: --other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", str(trees[which]),
               "--launches", str(args.launches), "--sizes", *map(str, args.sizes)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=trees[which],
                              env={**os.environ, "PYTHONPATH": str(trees[which])})
        if proc.returncode != 0:
            raise SystemExit(f"measure_x_stage: the {which} tree failed:\n{proc.stderr[-4000:]}")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{which} ({trees[which]}): {runs[which][-1]}", flush=True)
    result = {}
    for n in map(str, args.sizes):
        for name in PASSES:
            med = {w: statistics.median(r["ms"][n][name] for r in runs[w]) for w in runs}
            result[f"{name} {n}^3"] = {"other_ms": med["other"], "this_ms": med["this"],
                                        "this_over_other": med["this"] / med["other"]}
            print(f"{name:9s} {n}^3: other {med['other']:.4f} ms, this {med['this']:.4f} ms,"
                  f" this/other {med['this'] / med['other']:.3f}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
