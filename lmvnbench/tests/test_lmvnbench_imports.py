"""The import guard: no run loads JAX or the JAX package, nothing under
lmvnbench/ reads the JAX package's benchmark, and the reference imports
nothing of the program."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

from lmvnbench.guard import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_top_level_names_compared_whole():
    assert forbidden_modules(["libmultiviewnative_torch", "libmultiviewnative_torch.ops",
                              "jaxtyping", "jax_like", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "libmultiviewnative_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "libmultiviewnative_tpu"]


def test_run_loads_no_jax(tiny_root):
    """A whole run on the CPU, in a fresh interpreter, leaves no forbidden
    module in ``sys.modules``."""
    code = (
        "import sys, io\n"
        "from lmvnbench.manifest import Manifest\n"
        "from lmvnbench.run import run_cell\n"
        "from lmvnbench.guard import forbidden_modules\n"
        f"m = Manifest({str(tiny_root)!r})\n"
        "r = run_cell(m, 'tiny_v4_256_pervoxel.tiny_single', 3, 0.1, False, device='cpu',"
        " out=io.StringIO())\n"
        "assert r['line']['correct'], r\n"
        "print('FOUND', forbidden_modules())\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "FOUND []" in out.stdout


def test_benchmark_reads_no_jax_benchmark():
    pattern = re.compile(r"bench\.py|benchmarks/|BENCH_")
    me = Path(__file__).name
    hits = [str(p) for p in BENCH.rglob("*") if p.suffix in (".py", ".json")
            and p.name != me and pattern.search(p.read_text())]
    assert hits == []


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(n.split(".")[0] in ("torch", "typing", "__future__") for n in names), (
                path, names)
    code = ("import sys, lmvnbench.reference\n"
            "print(sorted(n for n in sys.modules if n.startswith('libmultiviewnative')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
