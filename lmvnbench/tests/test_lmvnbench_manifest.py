"""The harness is driven by data: the manifest keeps to its own rules,
a configuration, a traffic mix, a cell and a per-layer metric added as new
files and entries are picked up with no edit to a file already there, and
a host with no card fails the run."""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from lmvnbench.manifest import NAME, UNIT, Manifest
from lmvnbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]


def test_manifest_keeps_its_rules():
    m = Manifest(ROOT)
    assert m.problems() == []
    d = m.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lmvnbench/")
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for kind in ("end_to_end", "per_layer"):
        for x in d[kind]:
            assert NAME.fullmatch(x["name"]) and UNIT.fullmatch(x["unit"])
            assert x["better"] in ("lower", "higher")
    for x in d["per_layer"]:
        assert x["moves"] in {e["name"] for e in d["end_to_end"]}
    assert "setup_s" in {e["name"] for e in d["end_to_end"]}


def test_rules_catch_bad_names(tmp_path):
    shutil.copytree(ROOT / "lmvnbench", tmp_path / "lmvnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "bad name", "config": "nope", "traffic": "absent",
                           "chips": 1, "why": "x"})
    d["per_layer"].append({"name": "no_reader", "unit": "tokens per s", "better": "lower",
                           "source": "device_trace", "layer": "x", "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    found = " ".join(Manifest(tmp_path).problems())
    for what in ("'bad name'", "'nope'", "absent", "no_reader.py", "'tokens per s'"):
        assert what in found


def test_new_files_are_picked_up(tiny_root):
    """The tiny configurations, mixes, cells and the probe metric exist only
    as new files and entries of the copy; the harness runs them."""
    m = Manifest(tiny_root)
    assert m.problems() == []
    for name in ("tiny_v4_512_adjoint.tiny_single", "tiny_v4_256_pervoxel.tiny_batch2"):
        r = run_cell(m, name, 2**31 + 5, 0.1, True, device="cpu", out=io.StringIO())
        line = r["line"]
        assert line["correct"], r["checks"]
        assert line["metrics"]["tiny_probe"] == {"value": 1.5, "unit": "x"}
        assert "fused_ms_per_stack" not in line["metrics"]
        assert list(line)[-1] == "checks"
    r = run_cell(m, "tiny_v4_256_pervoxel.tiny_batch2", 7, 0.1, False, device="cpu",
                 out=io.StringIO())
    assert set(r["line"]["metrics"]) == {"stacks_per_s", "stack_ms_p90", "peak_mem_gib", "setup_s"}
    assert r["line"]["attempted"] % 2 == 0


def test_no_card_fails_the_run(tmp_path):
    """On a host with no card (hidden here), and in a directory holding only
    BENCHMARK.json and lmvnbench/, the command exits non-zero with a clear
    message and prints no result."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    args = [*bench["command"][1:], "--workload", cell, "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "No CPU fallback" in out.stderr
    assert out.stdout.strip() == ""
    shutil.copytree(ROOT / "lmvnbench", tmp_path / "lmvnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


def test_batch_cell_reads_the_fused_engine():
    """``v4_256_batch4`` runs on the fused engine (``auto`` gives a batch
    the engine of one volume): the fused engine's device time is read
    there, cuFFT's only in the 6-view cell, where the fft engine runs."""
    m = Manifest(ROOT)
    names = {x["name"] for x in m.metrics("per_layer", "v4_256_batch4")}
    assert "fused_ms_per_stack" in names and "cufft_ms_per_stack" not in names
    cufft = [x for x in m.data["per_layer"] if x["name"] == "cufft_ms_per_stack"]
    assert cufft[0]["workloads"] == ["v6_300x1024_timelapse"]


def test_the_log_names_the_engine_of_one_volume(tiny_root, monkeypatch):
    """The engine the log names for a batched cell is ``auto``'s for one of
    its volumes, asked as the program asks it (no streamed chunk)."""
    from libmultiviewnative_torch.deconv import rl

    asked = []
    resolve = rl.resolve_algorithm

    def spy(*args, **kwargs):
        asked.append(kwargs)
        return resolve(*args, **kwargs)

    monkeypatch.setattr(rl, "resolve_algorithm", spy)
    log = io.StringIO()
    run_cell(Manifest(tiny_root), "tiny_v4_256_pervoxel.tiny_batch2", 2**31 + 9, 0.1, False,
             device="cpu", out=log)
    assert asked and not any(k.get("chunk") for k in asked)
    engine = resolve("auto", (32, 32, 32), "cpu")
    assert f"# auto engine: {engine};" in log.getvalue()
