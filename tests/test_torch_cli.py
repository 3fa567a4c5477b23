"""The port's command-line tool (``cli.py``) with ``--platform cpu``: the JAX
CLI's cases (tests/test_cli.py), and the port's output against the JAX
CLI's on the same files.

Tolerance against JAX: 1e-4 of max|psi| (test_torch_rl.py's RTOL; both
packages run the same engine choice, in another FFT's rounding).
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.cli import main as jax_cli
from libmultiviewnative_torch.cli import main as cli_main
from libmultiviewnative_torch.io.stacks import (
    load_stack_h5,
    read_tiff_stack,
    save_stack_h5,
    write_tiff_stack,
)
from libmultiviewnative_torch.reference.numpy_ref import np_convolve_spectrum, np_wrap_kernel
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-4
CPU = ["--platform", "cpu"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bead_views(tmp_path, shape=(16, 16, 16), num=2):
    phantom = np.full(shape, 1.0)
    phantom[tuple(s // 2 for s in shape)] = 300.0
    args = []
    for v in range(num):
        psf = gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v)
        blurred = np_convolve_spectrum(phantom, np.fft.rfftn(np_wrap_kernel(psf, shape)))
        vp, kp = str(tmp_path / f"view{v}.tif"), str(tmp_path / f"psf{v}.tif")
        write_tiff_stack(vp, blurred.astype(np.float32))
        write_tiff_stack(kp, psf)
        args += ["--view", vp, "--psf", kp]
    return args


@pytest.mark.parametrize("algorithm", ["fft", "auto"])
def test_cli_roundtrip_matches_jax(tmp_path, capsys, algorithm):
    view_args = _bead_views(tmp_path)
    common = ["-i", "8", "--lambda", "0", "--algorithm", algorithm]
    out = str(tmp_path / "deconv.tif")
    assert cli_main(view_args + ["-o", out] + common + CPU) == 0
    assert "wrote" in capsys.readouterr().out
    result = read_tiff_stack(out)
    assert result.shape == (16, 16, 16)
    # deconvolution sharpened the bead
    assert result[8, 8, 8] > read_tiff_stack(str(tmp_path / "view0.tif"))[8, 8, 8]
    jax_out = str(tmp_path / "jax.tif")
    assert jax_cli(view_args + ["-o", jax_out] + common) == 0
    assert _rel(result, read_tiff_stack(jax_out)) <= RTOL


def test_cli_arg_validation(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(["--view", "a.tif", "-o", "x.tif"] + CPU)  # missing --psf
    with pytest.raises(SystemExit):
        cli_main(["--view", "a.tif", "--psf", "k.tif", "-o", "x.tif", "--platform", "tpu"])


def test_cli_h5_roundtrip_matches_jax(tmp_path):
    """h5 inputs (file:dataset) and h5 output, from a Wiener start."""
    shape = (12, 12, 12)
    psf = gaussian_kernel((5, 5, 5), 1.2)
    blurred = np_convolve_spectrum(
        np.full(shape, 1.0), np.fft.rfftn(np_wrap_kernel(psf, shape))
    ).astype(np.float32)
    vp, kp = str(tmp_path / "views.h5"), str(tmp_path / "psf.tif")
    save_stack_h5(vp, v0=blurred)
    write_tiff_stack(kp, psf)
    args = ["--view", f"{vp}:v0", "--psf", kp, "-i", "3", "--lambda", "0", "--init", "wiener"]
    out, jax_out = str(tmp_path / "out.h5"), str(tmp_path / "jax.h5")
    assert cli_main(args + ["-o", out] + CPU) == 0
    assert jax_cli(args + ["-o", jax_out]) == 0
    result = load_stack_h5(out, "psi")
    assert result.shape == shape
    assert _rel(result, load_stack_h5(jax_out, "psi")) <= RTOL


def test_cli_rejects_even_psf_without_kernel2(tmp_path):
    """Default kernel2=flip(psf) is a shifted adjoint for even kernel dims;
    the CLI must refuse it."""
    shape = (8, 8, 8)
    vp, kp = str(tmp_path / "v.tif"), str(tmp_path / "k.tif")
    write_tiff_stack(vp, np.ones(shape, np.float32))
    write_tiff_stack(kp, np.ones((4, 4, 4), np.float32) / 64.0)  # even dims
    with pytest.raises(SystemExit):
        cli_main(["--view", vp, "--psf", kp, "-o", str(tmp_path / "o.tif")] + CPU)


def test_cli_dispatch_auto(tmp_path):
    """--dispatch auto routes through the capacity ladder (in-core here)
    and gives the in-core result, and the JAX CLI's."""
    shape = (16, 16, 16)
    rng = np.random.default_rng(5)
    vp, kp = str(tmp_path / "v.tif"), str(tmp_path / "k.tif")
    write_tiff_stack(vp, rng.gamma(2.0, 20.0, shape).astype(np.float32))
    write_tiff_stack(kp, gaussian_kernel((5, 5, 5), 1.0))
    outs = {}
    for mode in ("incore", "auto"):
        op = str(tmp_path / f"out_{mode}.tif")
        assert cli_main(["--view", vp, "--psf", kp, "-o", op, "-i", "2",
                         "--dispatch", mode] + CPU) == 0
        outs[mode] = read_tiff_stack(op)
    np.testing.assert_allclose(outs["incore"], outs["auto"], rtol=1e-6)
    jax_out = str(tmp_path / "jax.tif")
    assert jax_cli(["--view", vp, "--psf", kp, "-o", jax_out, "-i", "2",
                    "--dispatch", "auto"]) == 0
    assert _rel(outs["auto"], read_tiff_stack(jax_out)) <= RTOL


def test_cli_defaults_to_the_card(tmp_path):
    """Without --platform every tensor goes to the card; where there is
    none the tool raises and writes nothing."""
    view_args = _bead_views(tmp_path, shape=(8, 8, 8), num=1)
    out = tmp_path / "card.tif"
    if torch.cuda.is_available():
        assert cli_main(view_args + ["-o", str(out), "-i", "1"]) == 0
        return
    with pytest.raises((AssertionError, RuntimeError)):
        cli_main(view_args + ["-o", str(out), "-i", "1"])
    assert not out.exists()
