"""The port imports and runs with JAX blocked from import: the machine with
the card has no JAX."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch
    torch.set_num_threads(1)
    import libmultiviewnative_torch as mvn
    from libmultiviewnative_torch import api, cli, native_client, native_entry
    from libmultiviewnative_torch.io import checkpoint, stacks
    from libmultiviewnative_torch.parallel import distributed, halo, loader, sharded
    from libmultiviewnative_torch.reference import numpy_ref
    from libmultiviewnative_torch.utils import logging, printing, psf, trace, validate
    from libmultiviewnative_torch.utils.synthetic import multiview_data

    ws = mvn.Workspace.from_views(
        multiview_data(2, (8, 8, 8), (3, 3, 3), (3, 3, 3), kernel="gaussian"),
        lambda_=0.006, num_iterations=2,
        device="cpu",
    )
    out = mvn.deconvolve(mvn.initial_psi(ws.data), ws.data, 2, lam=0.006)
    assert out.shape == (8, 8, 8) and bool(torch.isfinite(out).all())
    assert sys.modules["jax"] is None
    assert not any(m.startswith("libmultiviewnative_tpu") for m in sys.modules)
    print("ok")
    """
)


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_a_host_without_cuda(tmp_path):
    """chip_smoke.py fails, and prints no result line, where there is no
    card and where it stands alone without the package."""
    if torch.cuda.is_available():
        return
    script = os.path.join(REPO, "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(script).read())
    for path, cwd in ((script, REPO), (str(alone), str(tmp_path))):
        proc = subprocess.run(
            [sys.executable, path], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
