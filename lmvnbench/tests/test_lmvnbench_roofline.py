"""The least-work count: a function of the configuration and the traffic
alone, the same whichever engine runs, and a share that cannot pass 1 for
any time at or above the least time."""

import inspect
import json
import math
from pathlib import Path

import pytest

from lmvnbench import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_depends_on_configuration_and_traffic_only():
    assert list(inspect.signature(roofline.call_work).parameters) == ["cfg", "batch"]
    c = cfg("v4_256_pervoxel")
    # keys the engine, the kernels or the card would set change nothing
    extra = dict(c, algorithm="fused", engine="fft", device="cuda", kernels="K4 K6 K8 K9")
    assert roofline.call_work(extra, 1) == roofline.call_work(c, 1)
    assert roofline.call_work(dict(c, engine="fft"), 4) == roofline.call_work(c, 4)


def test_headline_count():
    c = cfg("v4_256_pervoxel")
    n, half = 256**3, 256 * 256 * 129
    step = 4 * 4 * n + 2 * 8 * half  # psi, view, weights, psi written; two spectra
    w = roofline.call_work(c, 1)
    assert w["bytes"] == 40 * step + 4 * 2 * 8 * half
    assert w["flops"] == pytest.approx(40 * 4 * 2.5 * n * 24)
    assert roofline.bound_by(w) == "bytes"
    assert roofline.least_seconds(w) == pytest.approx(w["bytes"] / 3.35e12)


def test_adjoint_and_batch_counts():
    a = roofline.call_work(cfg("v4_512_adjoint"), 1)
    n, half = 512**3, 512 * 512 * 257
    assert a["step_bytes"] == 3 * 4 * n + 8 * half  # scalar weights, one spectrum
    assert a["forwarded_bytes"] == 4 * 8 * half
    c = cfg("v4_256_pervoxel")
    one, four = roofline.call_work(c, 1), roofline.call_work(c, 4)
    n, half = 256**3, 256 * 256 * 129
    # shared weights and spectra read once a batched view step
    assert four["step_bytes"] == 4 * 3 * 4 * n + 4 * n + 2 * 8 * half
    assert four["flops"] == pytest.approx(4 * one["flops"])
    assert four["bytes"] < 4 * one["bytes"]


@pytest.mark.parametrize("name", ["v4_256_pervoxel", "v4_512_adjoint"])
@pytest.mark.parametrize("factor", [1.0, 1.0000001, 1.5, 10.0, 1e6])
def test_share_never_exceeds_one(name, factor):
    least = roofline.least_seconds(roofline.call_work(cfg(name), 1))
    s = roofline.share(least, least * factor)
    assert 0.0 < s <= 1.0
    assert roofline.share(least, 0.0) is None
    assert math.isclose(roofline.share(least, least), 1.0)
