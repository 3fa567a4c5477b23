"""Readings that set a cell's limit on ``psi_err``, in one process.

    python3 -m lmvnbench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

For each seed, one short run of the cell through the harness's own window
and comparison (the lower reading: the program as the configuration states
it).  For each control seed, the same with the program replaced by its
controls, each a step below float32:

* ``program_bf16``: the program with its own bf16 path on
  (``LMVN_FUSED_SPEC_BF16=1``, the fused spectra stored as bfloat16), where
  the cell runs the fused engine;
* ``reference_bf16``: the plain reference in the program's place, every
  stored value rounded to bfloat16.

Prints one JSON line per reading and a summary last.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import io
import json

from . import reference
from .manifest import Manifest
from .run import env_set, run_cell


def reference_solver(cfg: dict, storage):
    """The plain reference at float32 with its stored values rounded to
    ``storage``, called as the program is."""
    import torch

    def solve(psi0, data):
        return reference.deconvolve(psi0, data.views, data.kernel1, data.kernel2, data.weights,
                                    cfg["iterations"], cfg["lam"], cfg["min_value"],
                                    cfg["adjoint_kernel2"], dtype=torch.float32,
                                    storage=storage)

    return solve


def reading(manifest, workload, seed, seconds, device, solve=None) -> dict:
    log = io.StringIO()
    res = run_cell(manifest, workload, seed, seconds, False, device=device, solve=solve, out=log)
    line = res["line"]
    return {"seed": seed, "psi_err": res["checks"]["psi_err"]["value"],
            "failed": line["failed"], "attempted": line["attempted"], "log": log.getvalue()}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m lmvnbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lmvnbench.calibrate: CUDA is not available")
    manifest = Manifest()
    cfg = manifest.config(manifest.cell(args.workload)["config"])
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",")]
    summary = {"program": [], "program_bf16": [], "reference_bf16": []}

    def emit(kind, r):
        print(json.dumps({"kind": kind, **{k: v for k, v in r.items() if k != "log"}}),
              flush=True)

    for i, s in enumerate(seeds):
        r = reading(manifest, args.workload, s, args.seconds, args.device)
        if i == 0:
            print(r["log"], end="", flush=True)
        summary["program"].append(r)
        emit("program", r)
    from libmultiviewnative_torch.deconv.rl import resolve_algorithm

    batch = manifest.traffic(manifest.cell(args.workload)["traffic"])["batch"]
    fused = resolve_algorithm("auto", cfg["shape"], torch.device(args.device),
                              chunk=batch > 1) == "fused"
    for s in controls:
        if fused:
            with env_set("LMVN_FUSED_SPEC_BF16", "1"):
                r = reading(manifest, args.workload, s, args.seconds, args.device)
            summary["program_bf16"].append(r)
            emit("program_bf16", r)
        r = reading(manifest, args.workload, s, args.seconds, args.device,
                    solve=reference_solver(cfg, torch.bfloat16))
        summary["reference_bf16"].append(r)
        emit("reference_bf16", r)
    out = {"workload": args.workload,
           "lower": max(r["psi_err"] for r in summary["program"]),
           "program": sorted(r["psi_err"] for r in summary["program"])}
    for kind in ("program_bf16", "reference_bf16"):
        if summary[kind]:
            out[kind] = sorted(r["psi_err"] for r in summary[kind])
    print(json.dumps({"summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
