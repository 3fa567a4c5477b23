"""The port's numpy reference and utilities against the JAX package's:
``reference/numpy_ref.py`` and ``utils/psf.py`` bitwise (the same float64
numpy code), ``utils/validate.py`` on NaN and Inf, ``utils/trace.py`` (the
trace flag, a wall-clock ``profile_region``, ``span``, a profiler trace that
carries the spans, and ``debug_context``), ``utils/logging.py``'s row
against JAX's, and ``utils/printing.py``.
"""

import os

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.reference import numpy_ref as jref
from libmultiviewnative_tpu.utils import logging as jlogging, printing as jprinting, psf as jpsf
from libmultiviewnative_torch.deconv.workspace import MultiViewData
from libmultiviewnative_torch.ops import elementwise as ew
from libmultiviewnative_torch.reference import numpy_ref
from libmultiviewnative_torch.utils import logging as tlogging, printing, psf
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel
from libmultiviewnative_torch.utils.trace import (
    debug_context,
    profile_region,
    span,
    trace_enabled,
)
from libmultiviewnative_torch.utils.validate import check_finite, validate_workspace

torch.set_num_threads(1)


def test_numpy_ref_matches_jax_bitwise():
    rng = np.random.default_rng(11)
    shape = (8, 6, 10)
    psi = rng.gamma(2.0, 5.0, shape)
    views = [rng.gamma(2.0, 20.0, shape) for _ in range(2)]
    k1s = [gaussian_kernel((3, 5, 3), 1.0 + 0.4 * v) for v in range(2)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [rng.uniform(0.2, 0.8, shape) for _ in range(2)]
    np.testing.assert_array_equal(numpy_ref.np_wrap_kernel(k1s[0], shape),
                                  jref.np_wrap_kernel(k1s[0], shape))
    k_hat = np.fft.rfftn(numpy_ref.np_wrap_kernel(k1s[0], shape))
    np.testing.assert_array_equal(numpy_ref.np_convolve_spectrum(psi, k_hat),
                                  jref.np_convolve_spectrum(psi, k_hat))
    integral = rng.uniform(-0.2, 2.0, shape)
    np.testing.assert_array_equal(numpy_ref.np_final_values(psi, integral, ws[0], 1e-4),
                                  jref.np_final_values(psi, integral, ws[0], 1e-4))
    np.testing.assert_array_equal(
        numpy_ref.np_regularized_final_values(psi, integral, ws[0], 0.006, 1e-4),
        jref.np_regularized_final_values(psi, integral, ws[0], 0.006, 1e-4))
    for lam in (0.0, 0.006):
        np.testing.assert_array_equal(
            numpy_ref.np_rl_view_step(psi, views[0], k_hat, k_hat.conj(), ws[0], lam, 1e-4),
            jref.np_rl_view_step(psi, views[0], k_hat, k_hat.conj(), ws[0], lam, 1e-4))
    got = numpy_ref.np_deconvolve(psi, views, k1s, k2s, ws, 2, lam=0.006,
                                  record_iterations=True)
    want = jref.np_deconvolve(psi, views, k1s, k2s, ws, 2, lam=0.006, record_iterations=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "mode, output_shape",
    [("adjoint", None), ("adjoint", (7, 7, 7)), ("independent", None),
     ("efficient_bayesian", None), ("efficient", (9, 9, 9)), ("optimization_i", None),
     ("optimization_ii", (9, 9, 9))],
)
def test_compound_kernels_match_jax_bitwise(mode, output_shape):
    psfs = [gaussian_kernel((5, 5, 5), 0.8 + 0.3 * v) for v in range(3)]
    psfs[1] = gaussian_kernel((3, 5, 5), 0.9)  # a smaller support
    got = psf.compound_kernels(psfs, mode=mode, output_shape=output_shape)
    want = jpsf.compound_kernels(psfs, mode=mode, output_shape=output_shape)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_psf_helpers_and_errors():
    k = np.zeros((3, 3, 3), np.float32)
    k[0, 1, 2] = 1.0
    assert psf.flip_adjoint(k)[2, 1, 0] == 1.0
    with pytest.raises(ValueError, match="non-positive mass"):
        psf.normalize_l1(np.zeros((3, 3, 3)))
    with pytest.raises(ValueError, match="unknown compound mode"):
        psf.compound_kernels([k], mode="bogus")


def _data(bad=None):
    v = np.ones((2, 4, 4, 4), np.float32)
    k = np.ones((2, 3, 3, 3), np.float32)
    w = np.ones((2, 4, 4, 4), np.float32)
    if bad == "nan":
        v[0, 0, 0, 0] = np.nan
    if bad == "inf":
        w[1, 1, 1, 1] = np.inf
    t = torch.from_numpy
    return MultiViewData(t(v), t(k), t(k.copy()), t(w))


def test_validate_workspace_on_nan_and_inf():
    assert validate_workspace(_data()) == []
    with pytest.raises(ValueError, match="views contains NaN"):
        validate_workspace(_data("nan"))
    assert validate_workspace(_data("inf"), raise_on_bad=False) == ["weights contains Inf"]


def test_check_finite():
    with pytest.raises(ValueError, match="x contains NaN"):
        check_finite(np.array([np.nan]), "x", raise_on_bad=True)
    assert check_finite(torch.tensor([np.inf, np.nan]), "t") == ["t contains NaN", "t contains Inf"]
    assert check_finite(np.zeros(3)) == []


def test_trace_flag(monkeypatch):
    monkeypatch.setenv("LMVN_TRACE", "0")
    assert not trace_enabled()
    monkeypatch.setenv("LMVN_TRACE", "1")
    assert trace_enabled()


def test_profile_region_wallclock(capsys, monkeypatch):
    monkeypatch.setenv("LMVN_TRACE", "1")
    monkeypatch.delenv("LMVN_PROFILE_DIR", raising=False)
    with profile_region("unit"):
        with span("lmvn.inner"):
            torch.ones(4).sum()
    out = capsys.readouterr().out
    assert "unit:" in out and "ms" in out
    monkeypatch.setenv("LMVN_TRACE", "0")
    with profile_region("quiet"):
        pass
    assert capsys.readouterr().out == ""


def test_profile_region_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("LMVN_PROFILE_DIR", raising=False)
    with profile_region("traced", logdir=str(tmp_path)):
        with span("lmvn.inner"):
            torch.ones(8).cumsum(0)
    (trace,) = [name for name in os.listdir(tmp_path) if name.endswith(".json")]
    assert '"lmvn.inner"' in (tmp_path / trace).read_text()


def test_debug_context_raises_at_the_producing_op():
    with pytest.raises(FloatingPointError, match="log"):
        with debug_context(nan_checks=True):
            torch.log(torch.zeros(4) - 1)
    # state restored afterwards: the same op returns NaN quietly
    assert bool(torch.isnan(torch.log(torch.zeros(4) - 1)).all())
    with debug_context(nan_checks=True, disable_jit=True):
        torch.log(torch.ones(4))  # finite: nothing raised
        torch.empty(16)  # uninitialised memory is not scanned
    with debug_context(nan_checks=True):
        with debug_context(nan_checks=False):
            torch.log(torch.zeros(4) - 1)  # an inner scope turns the checks off


def test_debug_context_scans_the_kernel_wrappers():
    """K2's 0 * (1/0) through the wrapper (its plain version on the CPU)."""
    zeros = torch.zeros(8)
    with pytest.raises(FloatingPointError):
        with debug_context():
            ew.quotient(zeros, zeros)
    assert bool(torch.isnan(ew.quotient(zeros, zeros)).all())


def test_bench_row_matches_jax():
    kw = dict(n_devices=1, dev_type="gpu", dev_name="NVIDIA H100 80GB HBM3", n_repeats=10,
              total_time_ms=55.123456789, dims=(256, 256, 256), comment="4 views fft")
    assert tlogging.BenchRow(**kw).line() == jlogging.BenchRow(**kw).line()
    assert tlogging.BenchRow(**dict(kw, comment="")).line().endswith(" -")
    if torch.cuda.is_available():
        assert tlogging.current_device_row(1, 1.0, (8, 8, 8)).dev_type == "gpu"
    else:
        with pytest.raises(RuntimeError):
            tlogging.current_device_row(1, 1.0, (8, 8, 8))


def test_format_stack_matches_jax():
    a = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4) / 7
    assert printing.format_stack(a) == jprinting.format_stack(a)
    assert printing.format_stack(torch.from_numpy(a)) == jprinting.format_stack(a)
    big = np.zeros((10, 2, 2), np.float32)
    assert "2 more planes" in printing.format_stack(big)
    assert printing.format_stack(np.arange(3.0)) == jprinting.format_stack(np.arange(3.0))
