"""``BENCHMARK.json`` and the files it names.

The harness is driven by data: a cell names a configuration and a traffic
mix, each a file of its own (``configs/<config>.json`` by the path the
manifest gives, ``traffic/<traffic>.json``), and each metric is a reader of
its own (``end_to_end/<name>.py``, ``metrics/<name>.py``), found by its name.
A configuration, a mix, a cell or a metric is added by adding files and
entries, with no edit to a file that is already there.

A metric named ``<base>.<group>`` with no file of its own is read by
``<base>.py``: one quantity split by the cells whose end-to-end metric it
moves, as ``stacks_per_s`` and ``stacks_per_s.short`` are.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def default_root() -> Path:
    """The checkout: the directory that holds ``BENCHMARK.json`` and this
    package."""
    return PACKAGE.parent


class Manifest:
    """``BENCHMARK.json`` under ``root``, and the cells, configurations,
    traffic mixes and metric readers it names."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else default_root()
        self.bench_dir = self.root / PACKAGE.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        """The configuration's file, as it is run."""
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        whose ``workloads`` list it; of those with no such list, every
        end-to-end metric, and each per-layer metric whose ``moves`` the
        cell reports."""
        if kind == "end_to_end":
            return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]
        e2e = {m["name"] for m in self.metrics("end_to_end", cell)}
        return [m for m in self.data[kind]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, kind: str, name: str):
        """The ``read`` function of a metric's own file:
        ``end_to_end/<name>.py`` or ``metrics/<name>.py``."""
        folder = {"end_to_end": "end_to_end", "per_layer": "metrics"}[kind]
        path = self.reader_path(folder, name)
        spec = importlib.util.spec_from_file_location(f"lmvnbench_{folder}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def reader_path(self, folder: str, name: str) -> Path:
        """``<folder>/<name>.py``, else the file of the name's base (the
        part before its first dot)."""
        path = self.bench_dir / folder / f"{name}.py"
        if not path.is_file() and "." in name:
            path = self.bench_dir / folder / f"{name.split('.', 1)[0]}.py"
        return path

    def problems(self) -> list:
        """What in the manifest breaks its own rules: names and units out of
        their characters, and names that resolve to no file."""
        out = []
        d = self.data
        named = [("config", c["name"]) for c in d["configs"]]
        named += [("workload", w["name"]) for w in d["workloads"]]
        named += [(k, m["name"]) for k in ("end_to_end", "per_layer") for m in d[k]]
        named += [("traffic", w["traffic"]) for w in d["workloads"]]
        named += [("reduced", r) for c in d["configs"] for r in c["reduced"]]
        out += [f"{what} name {n!r}" for what, n in named if not NAME.fullmatch(n)]
        out += [f"unit {m['unit']!r} of {m['name']}" for k in ("end_to_end", "per_layer")
                for m in d[k] if not UNIT.fullmatch(m["unit"])]
        for c in d["configs"]:
            if not (self.root / c["file"]).is_file():
                out.append(f"config file {c['file']} missing")
        for w in d["workloads"]:
            if w["config"] not in self.configs:
                out.append(f"workload {w['name']} names no config {w['config']!r}")
            if not (self.bench_dir / "traffic" / f"{w['traffic']}.json").is_file():
                out.append(f"traffic file of {w['traffic']} missing")
        for kind, folder in (("end_to_end", "end_to_end"), ("per_layer", "metrics")):
            for m in d[kind]:
                if not self.reader_path(folder, m["name"]).is_file():
                    out.append(f"reader {folder}/{m['name']}.py missing")
                for w in m.get("workloads", []):
                    if w not in self.cells:
                        out.append(f"{m['name']} lists unknown workload {w!r}")
        for w in self.cells:
            e2e = {m["name"] for m in self.metrics("end_to_end", w)}
            if "setup_s" not in e2e or len(e2e) < 2 or not self.metrics("per_layer", w):
                out.append(f"workload {w} reports too few metrics")
            for m in self.metrics("per_layer", w):
                if m["moves"] not in e2e:
                    out.append(f"{m['name']} moves {m['moves']}, which {w} does not report")
        return out
