"""The port's spans (``utils/trace.py`` ``span``) on the CPU: the names,
their nesting and their count per ``deconvolve_auto`` call under
``torch.profiler``, none without a profiler, and the benchmark's outside
wrapper of ``deconv.rl._forward_spectra`` still entered once per call.

Problem: 2 views at 16³, 3³ kernels (the z-sparse forwarding on fused:
one pass A per kernel), per-voxel weights 1/V, 3 iterations.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils import trace
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

SHAPE = (16, 16, 16)
V = 2
ITERS = 3
# engine spans of one view step outside the forwarding, and inside it per
# call, by engine
STEP = {
    "fused": {"pass_a": 1, "pass_b": 2, "pass_cqa": 1, "pass_cu": 1},
    "fft": {"convolve_spectrum": 2, "quotient": 1, "rl_update": 1},
}
FORWARD = {"fused": {"pass_a": 2 * V}, "fft": {}}


def _problem():
    rng = np.random.default_rng(3)
    views = rng.gamma(2.0, 20.0, (V,) + SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((V,) + SHAPE, 1.0 / V, np.float32)
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    return torch.full(SHAPE, float(views.mean())), data


def _call(algorithm):
    psi0, data = _problem()
    return deconvolve_auto(psi0, data, ITERS, lam=0.006, algorithm=algorithm, device="cpu")


def _spans(prof):
    """(start, end, name) of every ``lmvn.`` event, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith("lmvn."))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("algorithm", ["fused", "fft"])
def test_spans_of_a_call(algorithm):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _call(algorithm)
    assert torch.isfinite(out).all()
    spans = _spans(prof)
    one = lambda name: [s for s in spans if s[2] == name]
    (call,), (rung,), (driver,), (forward,) = (
        one("lmvn.call"), one("lmvn.rung.in_core"), one("lmvn.deconvolve"), one("lmvn.forward"))
    assert _inside(rung, call) and _inside(driver, rung) and _inside(forward, driver)
    assert not [s for s in spans if s[2].startswith("lmvn.rung.") and s is not rung]

    engine = [s for s in spans if s[2].startswith("lmvn.engine.")]
    assert all(_inside(s, driver) for s in engine)
    count = lambda group: {op: sum(s[2] == f"lmvn.engine.{op}" for s in group)
                           for op in {s[2].rsplit(".", 1)[1] for s in group}}
    in_forward = [s for s in engine if _inside(s, forward)]
    outside = [s for s in engine if not _inside(s, forward)]
    assert count(in_forward) == FORWARD[algorithm]
    assert count(outside) == {op: n * V * ITERS for op, n in STEP[algorithm].items()}
    assert len(outside) == {"fused": 5, "fft": 4}[algorithm] * V * ITERS
    # engine spans never nest: each is one engine entry
    assert not any(_inside(a, b) for a in engine for b in engine if a is not b)


def test_no_span_without_a_profiler(monkeypatch):
    """Without a profiler no ``lmvn.`` record is made at all, and ``span``
    is one shared null context; under one, every span is a record."""
    made = []

    def record(name):
        made.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(trace, "_RecordFunctionFast", record)
    assert trace.span("lmvn.a") is trace.span("lmvn.b")
    _call("fft")
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        _call("fft")
    assert made[0] == "lmvn.call" and len(made) == 4 + 4 * V * ITERS
    assert all(name.startswith("lmvn.") for name in made)


def test_outside_wrapper_of_the_forwarding_still_entered():
    """The benchmark wraps ``rl._forward_spectra`` from outside in a range of
    its own (``lmvnbench.run.forward_span``): entered once per call, with
    the program's ``lmvn.forward`` inside it."""
    from lmvnbench.profiling import FORWARD_RANGE
    from lmvnbench.run import forward_span

    notes = []
    with forward_span(True, notes), profile(activities=[ProfilerActivity.CPU]) as prof:
        _call("fused")
        _call("fft")
    assert notes == []
    ranges = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name == FORWARD_RANGE)
    forwards = [s for s in _spans(prof) if s[2] == "lmvn.forward"]
    assert len(ranges) == len(forwards) == 2
    assert all(_inside(f, r) for f, r in zip(forwards, ranges))
