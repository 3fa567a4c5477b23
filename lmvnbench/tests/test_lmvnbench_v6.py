"""The 6-view light-sheet deployment (``v6_300x1024x1024_pervoxel``) and its
cell ``v6_300x1024_timelapse``: the manifest keeps its rules and gives the
cell its metrics, and the cell, its configuration cut to (30, 64, 64) in a
copy of the checkout, runs through the harness on the CPU and is correct,
while the control a step below float32 is not."""

import io
import json
from pathlib import Path

import pytest
import torch

from lmvnbench.calibrate import reference_solver
from lmvnbench.manifest import Manifest
from lmvnbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
CONFIG = "v6_300x1024x1024_pervoxel"
CELL = "v6_300x1024_timelapse"
PER_LAYER = {"device_idle_share", "step_mfu", "engine_roofline", "launches_per_stack",
             "forward_ms_per_stack", "cufft_ms_per_stack", "ladder_idle_ms_per_stack",
             "forward_idle_ms_per_stack", "driver_idle_ms_per_stack",
             "engine_idle_ms_per_stack"}


def test_manifest_gives_the_cell_its_metrics():
    m = Manifest(ROOT)
    assert m.problems() == []
    cell = m.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "timelapse_pool2", 1)
    assert m.configs[CONFIG]["reduced"] == []
    assert {x["name"] for x in m.metrics("end_to_end", CELL)} == {
        "stacks_per_s", "stack_ms_p90", "peak_mem_gib", "setup_s"}
    assert {x["name"] for x in m.metrics("per_layer", CELL)} == PER_LAYER
    cfg = m.config(CONFIG)
    assert (cfg["shape"], cfg["views"], cfg["weights"]) == ([300, 1024, 1024], 6, "per_voxel")


def _cut(root: Path, shape=(30, 64, 64)) -> Manifest:
    """The copy's configuration file cut to ``shape``, everything else as
    it is."""
    path = root / "lmvnbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["shape"] = list(shape)
    cfg["reduced"] = ["shape"]
    path.write_text(json.dumps(cfg))
    return Manifest(root)


@pytest.mark.parametrize("trace", [False, True])
def test_cut_cell_runs_and_is_correct(tiny_root, trace):
    m = _cut(tiny_root)
    r = run_cell(m, CELL, 2**31 + 61, 0.1, trace, device="cpu", out=io.StringIO())
    line = r["line"]
    assert line["correct"], r["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    if trace:
        # the copy's own probe metric, listed for no cell, besides
        assert set(line["metrics"]) <= PER_LAYER | {"tiny_probe"}
        assert "fused_ms_per_stack" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"stacks_per_s", "stack_ms_p90", "peak_mem_gib",
                                        "setup_s"}


def test_cut_cell_control_is_not_correct(tiny_root):
    m = _cut(tiny_root)
    cfg = m.config(CONFIG)
    r = run_cell(m, CELL, 2**31 + 67, 0.1, False, device="cpu",
                 solve=reference_solver(cfg, torch.bfloat16), out=io.StringIO())
    assert not r["line"]["correct"]
    assert r["checks"]["psi_err"]["value"] > 3 * r["checks"]["psi_err"]["limit"]
