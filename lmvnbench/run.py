"""Run one cell of the port's benchmark, once, as a process of its own.

From the root of a checkout, on a host with an NVIDIA GPU:

    python3 -m lmvnbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

In order: load the port's kernels (built into ``build/torch_kernels/`` inside
the checkout on the first run there), make the cell's inputs on the card
from the seed, warm up the cell's own shapes, run the closed loop for
``--seconds`` (``--trace 1``: profile ``traced_requests`` requests instead),
compare the kept results with the plain reference, and print one JSON line
last.  Earlier lines, each starting with ``#``, say what ran: the card, the
engine the program's ``auto`` picked, the ladder's rung, the least-work
terms and any ``LMVN_*`` variable set.  A host without a card fails the
run; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
import traceback

from . import generator, guard, profiling, reference, roofline
from .inputs import stack_views, start_value
from .inputs import kernels as make_kernels
from .inputs import weights as make_weights
from .manifest import Manifest


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def program_solver(cfg: dict, device):
    """The system under test: the port's ``deconvolve_auto`` on the card,
    with the configuration's options and the program's defaults."""
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto

    def solve(psi0, data):
        return deconvolve_auto(psi0, data, cfg["iterations"], lam=cfg["lam"],
                               min_value=cfg["min_value"],
                               adjoint_kernel2=cfg["adjoint_kernel2"], device=device)

    return solve


@contextlib.contextmanager
def env_set(key: str, value: str):
    """``os.environ[key] = value`` for the body, restored afterwards."""
    before = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = before


@contextlib.contextmanager
def forward_span(enabled: bool, notes: list):
    """Wrap the per-call kernel forwarding (``deconv.rl._forward_spectra``)
    in a ``record_function`` range while a trace runs, from outside the
    program; restore it afterwards."""
    from libmultiviewnative_torch.deconv import rl

    fn = getattr(rl, "_forward_spectra", None)
    if not enabled or fn is None:
        if enabled:
            notes.append("deconv.rl._forward_spectra is gone: no forwarding span")
        yield
        return
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(profiling.FORWARD_RANGE):
            return fn(*a, **k)

    rl._forward_spectra = wrapped
    try:
        yield
    finally:
        rl._forward_spectra = fn


def host_report(say) -> None:
    """The card's name, power limit and clocks, and the ``LMVN_*``
    variables set."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        say(f"nvidia-smi {query}: {smi.stdout.strip() or smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        say(f"nvidia-smi unavailable: {e}")
    env = {k: v for k, v in os.environ.items() if k.startswith("LMVN_")}
    say(f"LMVN_* set: {env or 'none'}")


def check_results(cfg: dict, loop, kept: dict, seed: int, device, say) -> dict:
    """Compare each kept result, stack by stack, with the float64 reference
    run on inputs made again from the seed.  The number compared is the
    widest gap ``max|psi - ref| / max|ref|`` over the kept stacks; each
    stack's gap is logged with the seconds its check took."""
    import torch

    k1, k2 = make_kernels(cfg, device)
    w = make_weights(cfg, device)
    worst, compared = 0.0, 0
    for k in sorted(kept):
        res = kept[k]
        for b, t in enumerate(loop.time_points(k)):
            if res is None:
                worst = math.inf
                continue
            t0 = time.perf_counter()
            views = stack_views(cfg, seed, t, device)
            psi0 = torch.empty(tuple(cfg["shape"]), dtype=torch.float32, device=device)
            psi0.fill_(start_value(views))
            ref = reference.deconvolve(psi0, views, k1, k2, w, cfg["iterations"], cfg["lam"],
                                       cfg["min_value"], cfg["adjoint_kernel2"])
            del views, psi0
            got = res[b] if loop.batch > 1 else res
            gap = torch.sub(got, ref).abs_()  # got widened inside the op: no float64 copy
            err = float(gap.max() / ref.abs().max())
            worst = max(worst, err if math.isfinite(err) else math.inf)
            compared += 1
            say(f"check request {k} time point {t}: max|psi - ref| / max|ref| = {err!r} "
                f"({time.perf_counter() - t0:.3f} s)")
            del ref, got, gap
    return {"psi_err": worst, "compared": compared}


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, solve=None, out=None) -> dict:
    """One run of cell ``name``; returns the result line (``line``) and the
    numbers compared (``checks``).  ``solve`` stands in for the program
    (tests and the calibration's controls); ``out`` takes the ``#`` lines."""
    import torch

    out = out or sys.stdout
    t_start = time.perf_counter() if t_start is None else t_start

    def say(msg):
        print("#", msg, file=out, flush=True)

    cell = manifest.cell(name)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    from libmultiviewnative_torch.deconv import dispatch, rl

    if on_card:
        from libmultiviewnative_torch.ops import _build

        t = time.perf_counter()
        _build.library()
        say(f"kernels {_build.build()} loaded in {time.perf_counter() - t:.3f} s")
    t_kernels = time.perf_counter()
    loop = generator.ClosedLoop(cfg, traffic, seed, dev)
    sync()
    t_inputs = time.perf_counter()
    solve = solve or program_solver(cfg, dev)
    B = loop.batch
    engine = rl.resolve_algorithm("auto", cfg["shape"], dev)
    _, data0 = loop.request(0)
    est = dispatch.estimate_workspace_bytes(data0, "auto", dev, batch=B)
    cap = int(0.9 * dispatch.device_capacity_bytes(dev))
    del data0
    work = roofline.call_work(cfg, B)
    least_call = roofline.least_seconds(work)
    say(f"cell {name}: config {cell['config']} {cfg['views']} views {tuple(cfg['shape'])}, "
        f"traffic {cell['traffic']} (batch {B}, pool {loop.pool}), seed {seed}")
    say(f"auto engine: {engine}; ladder estimate {est} B against {cap} B "
        f"({'in-core rung' if est < cap else 'off-core rungs'})")
    say(f"least work a call: {work}; least time {least_call!r} s, bound by {roofline.bound_by(work)} "
        f"(peaks {roofline.PEAK_BYTES_PER_S:g} B/s, {roofline.PEAK_FLOPS:g} FLOP/s)")

    # set-up: warm the cell's own shapes; the first call prints the ladder's rung
    for k in range(traffic["warmup_requests"]):
        with env_set("LMVN_TRACE", "1") if k == 0 else contextlib.nullcontext():
            solve(*loop.request(k))
            sync()
    t_warm = time.perf_counter()
    say(f"set-up stages from the process's start: program imported and kernels loaded "
        f"{t_kernels - t_start:.3f} s, inputs made {t_inputs - t_start:.3f} s, "
        f"{traffic['warmup_requests']} warm-up requests done {t_warm - t_start:.3f} s")
    notes = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities):  # starts the tracer before the window
            solve(*loop.request(0))
            sync()
        prof = profile(activities=activities)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    sample = generator.Sample(traffic["check_requests"], seed)
    latencies, failed = [], 0
    request_range = (lambda: record_function(profiling.REQUEST_RANGE)) if trace else (
        contextlib.nullcontext)
    starts = []
    with forward_span(trace, notes), (prof or contextlib.nullcontext()):
        t_open = time.perf_counter()
        setup_s = t_open - t_start
        k, t_close = 0, t_open
        while (k < traffic["traced_requests"]) if trace else (
                k == 0 or time.perf_counter() - t_open < seconds):
            t0 = time.perf_counter()
            starts.append(t0 - t_open)
            with request_range():
                try:
                    res = solve(*loop.request(k))
                    sync()
                except Exception:  # a failed request counts, and the loop goes on
                    if failed == 0:
                        traceback.print_exc(file=sys.stderr)
                    failed += 1
                    res = None
            t_close = time.perf_counter()
            latencies.append(t_close - t0 if res is not None else math.inf)
            sample.offer(k, res)
            del res
            k += 1
    window_s = t_close - t_open
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    requests = k
    stacks = requests * B

    line = {"correct": False, "attempted": stacks, "failed": failed * B}
    metrics = {}
    if trace:
        w = profiling.window(prof, window_s, requests, stacks, least_call * requests, engine)
        del prof
        for m in manifest.metrics("per_layer", name):
            value = manifest.reader("per_layer", m["name"])(w)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for note in notes + w.notes:
            say(f"left out: {note}")
        busy_s = w.busy_s
    else:
        r = {"stacks_done": stacks, "window_s": window_s, "peak_bytes": peak,
             "setup_s": setup_s,
             "stack_latencies_s": [x for x in latencies for _ in range(B)]}
        for m in manifest.metrics("end_to_end", name):
            metrics[m["name"]] = {"value": manifest.reader("end_to_end", m["name"])(r),
                                  "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace:
        line["device"].update(busy_s=busy_s, window_s=window_s)
        line["breakdown"] = {"device_ops": profiling.device_ops(w),
                             "idle_gaps": profiling.idle_gaps(w)}
        del w
    done = sorted(x for x in latencies if math.isfinite(x)) or [math.nan]
    median = done[len(done) // 2]
    slow = [(i, round(starts[i], 3), round(x, 4)) for i, x in enumerate(latencies)
            if x > 1.5 * median]
    say(f"window: {requests} requests, {stacks} stacks, {failed} failed, {window_s!r} s; "
        f"setup {setup_s!r} s; peak {peak} B; request latency median {median!r} s, "
        f"max {done[-1]!r} s; over 1.5x the median (index, start s, latency s): {slow[:40]}")

    # the comparison, once the window has closed and the program's state is freed
    kept = sample.kept
    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    found = check_results(cfg, loop, kept, seed, dev, say)
    limit = cfg["check"]["psi_err"]
    checks = {"psi_err": {"value": found["psi_err"], "limit": limit},
              "failed": {"value": failed * B, "limit": 0}}
    line["correct"] = bool(failed == 0 and found["compared"] >= 1
                           and found["psi_err"] <= limit)
    line["checks"] = checks
    return {"line": line, "checks": checks}


def finite(x):
    """JSON has no infinity: a number that is not finite becomes null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    ap = argparse.ArgumentParser(prog="python3 -m lmvnbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter()
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"lmvnbench: the cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this host has {have} (torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}). No CPU fallback.", file=sys.stderr)
        return 2
    host_report(lambda m: print("#", m, flush=True))
    print(f"# from the process's start: torch imported {t_torch - t_start:.3f} s, host report "
          f"done {time.perf_counter() - t_start:.3f} s", flush=True)
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=t_start)
    found = guard.forbidden_modules()
    if found:
        print(f"lmvnbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(result["line"])), flush=True)
    return 0
