"""The four idle readers (``metrics/*_idle_ms_per_stack.py`` through
``spans.py``) on hand-built windows: exact values for known spans and
device intervals, the split against a microsecond-by-microsecond count,
the layers adding up to the idle time inside the requests, a window with
no ``lmvn.call``, and a traced CPU run of the program, whose spans they
read."""

import io
import json
import random
from pathlib import Path

import pytest

from lmvnbench import spans
from lmvnbench.manifest import Manifest
from lmvnbench.profiling import REQUEST_RANGE, Window
from lmvnbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]

READERS = {"ladder": "ladder_idle_ms_per_stack", "forward": "forward_idle_ms_per_stack",
           "driver": "driver_idle_ms_per_stack", "engine": "engine_idle_ms_per_stack"}


def _window(host, kernels, stacks=2):
    host = sorted((s, e, name) for name, s, e in host)
    kernels = [("k", s, e) for s, e in kernels]
    return Window(kernels, {}, host, 1e-3, 1, stacks, 0.0, "fused")


# (name, start us, end us): one request, one call of the in-core rung
HOST = [
    (REQUEST_RANGE, 0, 1000), ("lmvn.call", 100, 900), ("lmvn.rung.in_core", 150, 850),
    ("lmvn.deconvolve", 200, 800), ("lmvn.forward", 220, 320),
    ("lmvn.engine.pass_a", 230, 260), ("lmvn.engine.pass_b", 400, 450),
    ("lmvn.engine.pass_cu", 500, 550), ("aten::empty", 600, 610),
]
KERNELS = [(240, 300), (420, 600), (700, 760), (950, 980)]
# idle us: ladder [100,150] + [850,900]; forward [220,240] + [300,320];
# engine [400,420]; driver [150,220] + [320,400] + [600,700] + [760,800]
# + [800,850]; outside the call [0,100] + [900,950] + [980,1000]
WANT_US = {"ladder": 100, "forward": 40, "engine": 20, "driver": 340, "outside_call": 170}


@pytest.mark.parametrize("name", [n + sfx for n in READERS.values() for sfx in ("", ".short")])
def test_readers_give_exact_values(name):
    layer = {v: k for k, v in READERS.items()}[name.split(".")[0]]
    read = Manifest(ROOT).reader("per_layer", name)
    w = _window(HOST, KERNELS)
    assert read(w) == pytest.approx(1e3 * WANT_US[layer] / 1e6 / 2, abs=1e-12)
    assert w.notes == []


def test_layers_add_up_to_the_idle_inside_requests():
    split = spans.idle_split(_window(HOST, KERNELS))
    for key, us in WANT_US.items():
        assert split[key] == pytest.approx(us / 1e6, abs=1e-12)
    parts = sum(split[k] for k in (*spans.LAYERS, "outside_call"))
    assert parts == pytest.approx(split["requests"], abs=1e-12)
    assert split["requests"] == pytest.approx(670 / 1e6, abs=1e-12)


def _count(host, kernels):
    """The split by walking every microsecond: the first layer whose spans
    hold it, as ``spans.py`` documents."""
    out = dict.fromkeys((*spans.LAYERS, "outside_call", "requests"), 0)
    within = lambda t, names: any(s <= t < e for n, s, e in host if names(n))
    for t in range(0, max(e for _, _, e in host)):
        if any(s <= t < e for s, e in kernels) or not within(t, lambda n: n == REQUEST_RANGE):
            continue
        out["requests"] += 1
        if not within(t, lambda n: n == "lmvn.call"):
            out["outside_call"] += 1
            continue
        for layer in spans.LAYERS[:-1]:
            if within(t, lambda n: spans.layer_of(n) == layer):
                out[layer] += 1
                break
        else:
            out["ladder"] += 1
    return out


@pytest.mark.parametrize("seed", range(6))
def test_split_matches_a_count(seed):
    """Random calls of nested spans, some overlapping kernels, some host
    events and spans outside any call."""
    rng = random.Random(seed)
    host, kernels, t = [], [], 0
    for _ in range(3):
        r0 = t
        t += rng.randint(0, 20)
        for _ in range(rng.randint(1, 2)):
            c0 = t
            t += rng.randint(0, 15)
            d0 = t
            for _ in range(rng.randint(1, 4)):
                t += rng.randint(0, 10)
                name = rng.choice(["lmvn.forward", "lmvn.engine.pass_b", "aten::bmm"])
                s = t
                t += rng.randint(1, 25)
                if name == "lmvn.forward":
                    host.append(("lmvn.engine.pass_a", s + 1, t))
                host.append((name, s, t))
            t += rng.randint(0, 10)
            host += [("lmvn.deconvolve", d0, t), ("lmvn.rung.in_core", d0 - 1, t + 1)]
            t += rng.randint(2, 15)
            host.append(("lmvn.call", c0, t))
        host.append(("lmvn.engine.quotient", t, t + 5))  # outside any call
        t += rng.randint(6, 20)
        host.append((REQUEST_RANGE, r0, t))
        t += rng.randint(0, 10)
    for _ in range(rng.randint(0, 12)):
        s = rng.randint(0, t)
        kernels.append((s, s + rng.randint(1, 30)))
    split = spans.idle_split(_window(host, kernels))
    want = _count(host, kernels)
    for key, us in want.items():
        assert split[key] == pytest.approx(us / 1e6, abs=1e-12), key


def test_no_call_gives_none_and_a_note():
    w = _window([(REQUEST_RANGE, 0, 100), ("aten::empty", 10, 20)], [(0, 50)])
    m = Manifest(ROOT)
    for name in READERS.values():
        assert m.reader("per_layer", name)(w) is None
        assert m.reader("per_layer", name + ".short")(w) is None
    assert len(w.notes) == 8 and all("no lmvn.call span" in n for n in w.notes)
    assert spans.idle_split(w) is None


def test_a_traced_run_reads_the_programs_spans(tiny_root):
    """A traced CPU run of a tiny cell, the readers listed for it: the
    program records its spans and the readers find them (on the CPU no
    device activity covers any of the host's time)."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = "tiny_v4_256_pervoxel.tiny_single"
    for m in bench["per_layer"]:
        if m["name"] in READERS.values():
            m["workloads"].append(cell)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(Manifest(tiny_root), cell, 2**31 + 9, 0.1, True, device="cpu",
                 out=io.StringIO())
    got = r["line"]["metrics"]
    assert r["line"]["correct"], r["checks"]
    for name in READERS.values():
        assert got[name]["unit"] == "ms" and got[name]["value"] >= 0.0
    assert got["forward_idle_ms_per_stack"]["value"] > 0.0
    assert got["engine_idle_ms_per_stack"]["value"] > 0.0
