"""A copy of the benchmark with a configuration small enough for the CPU,
added the way a later change adds one: new files and new entries only."""

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TINY_TRAFFIC = {
    "tiny_single": {"driver": "closed_loop", "batch": 1, "pool": 2, "warmup_requests": 1,
                    "check_requests": 2, "traced_requests": 2},
    "tiny_batch2": {"driver": "closed_loop", "batch": 2, "pool": 2, "warmup_requests": 1,
                    "check_requests": 1, "traced_requests": 2},
}
PROBE = '"""A per-layer metric added as a file of its own."""\n\n\ndef read(w):\n    return 1.5\n'


def tiny_config(name: str, shape=(32, 32, 32)) -> dict:
    """The configuration ``name`` of the benchmark at a CPU test's size:
    every option as it is, the volume cut to ``shape``."""
    cfg = json.loads((ROOT / "lmvnbench" / "configs" / f"{name}.json").read_text())
    cfg["shape"] = list(shape)
    if cfg["weights"] == "per_voxel":
        cfg["reduced"] = ["shape"]
    return cfg


@pytest.fixture(scope="session", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path):
    """A checkout copy holding ``BENCHMARK.json`` and ``lmvnbench/`` plus,
    as new files and entries: both configurations at 32³, two traffic
    mixes, a cell for each pairing and one more per-layer metric."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "lmvnbench", root / "lmvnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("v4_256_pervoxel", "v4_512_adjoint"):
        tiny = f"tiny_{name}"
        (root / "lmvnbench" / "configs" / f"{tiny}.json").write_text(
            json.dumps(tiny_config(name)))
        bench["configs"].append({"name": tiny, "source": "test", "reduced": ["shape"],
                                 "file": f"lmvnbench/configs/{tiny}.json", "why": "test"})
        for traffic in TINY_TRAFFIC:
            bench["workloads"].append({"name": f"{tiny}.{traffic}", "config": tiny,
                                       "traffic": traffic, "chips": 1, "why": "test"})
    for traffic, params in TINY_TRAFFIC.items():
        (root / "lmvnbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(params))
    tiny_cells = [w["name"] for w in bench["workloads"] if w["name"].startswith("tiny_")]
    for m in bench["end_to_end"]:
        if m["name"] in ("stacks_per_s", "stack_ms_p90"):
            m["workloads"] = m["workloads"] + tiny_cells
    (root / "lmvnbench" / "metrics" / "tiny_probe.py").write_text(PROBE)
    bench["per_layer"].append({"name": "tiny_probe", "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "stacks_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
