"""The port's fused engine past the old CUDA limits (X > 1816, Z > 736),
against the JAX package's fused engine in Pallas interpret mode
(``precision="highest"``), as tests/test_torch_fused.py runs it.

The CUDA passes once refused X past 1816 and Z past 736 where the JAX
package's fused engine returns (ROADMAP queue 3, F11).  Their x and z stages
now narrow their tiles past those edges (ops/csrc/fft_stage.cuh), which
chip_smoke.py's phase 29 holds against the plain passes on the card.  Here,
on the CPU, the plain passes of one view step at X = 1824 and at Z = 744
(the first lengths of the 8-wide tiles, the other axes small) are held
against JAX's ``fused_rl_step_transposed``:

* pass A of psi over the (re, im) pair, 1e-5 of max|ref| (the fused
  passes' gate of tests/test_torch_fused.py);
* psi' after the five passes, 1e-5 of max|ref| plus the Tikhonov slack of
  K1 at λ = 0.006 (4 ulp(1)/λ absolute; see tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

RTOL = 1e-5
LAM = 0.006
MIN_VALUE = 1e-4


def _rel(got, want, atol=0.0):
    if isinstance(want, (tuple, list)):
        got = np.concatenate([np.asarray(g).ravel() for g in got])
        want = np.concatenate([np.asarray(w).ravel() for w in want])
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.max(np.maximum(np.abs(got - want) - atol, 0.0)) / np.abs(want).max())


# (Z, Y, X): X one step past the old 1816 edge, Z one step past 736
@pytest.mark.parametrize("shape", [(8, 8, 1824), (744, 8, 16)], ids=["X1824", "Z744"])
def test_fused_view_step_past_the_old_limits_matches_jax(shape):
    Z, Y, X = shape
    assert fu.fused_limit((Z, X, Y), "cuda") is None
    rng = np.random.default_rng(14)
    psi = rng.uniform(1.0, 100.0, (Z, X, Y)).astype(np.float32)
    view = rng.uniform(1.0, 200.0, (Z, X, Y)).astype(np.float32)
    w = rng.uniform(0.0, 0.5, (Z, X, Y)).astype(np.float32)
    k1 = gaussian_kernel((3, 3, 3), 1.0)
    k2 = np.flip(k1).copy()
    run = dict(interpret=True, precision="highest")
    jk = [fd.kernel_spectrum_fused(jnp.asarray(k), shape, precision="highest") for k in (k1, k2)]
    want_a = fd._run_pass_a(jnp.asarray(psi), fd.make_fused_plan(shape), 8, True, "highest")
    want = fd.fused_rl_step_transposed(jnp.asarray(psi), jnp.asarray(view), jnp.asarray(w),
                                       *jk, LAM, MIN_VALUE, **run)

    t = torch.from_numpy
    pk = [fu.kernel_spectrum_fused(t(k), shape) for k in (k1, k2)]
    fu.reset_launches()
    got_a = fu.pass_a(t(psi), fp.make_fused_plan(shape))
    got = fu.fused_rl_step_transposed(t(psi), t(view), *pk, t(w), LAM, MIN_VALUE)
    assert set(fu.launches.values()) == {0}  # the CPU path runs the plain passes
    assert _rel(got_a, [np.asarray(x) for x in want_a]) <= RTOL
    atol = 4 * float(np.finfo(np.float32).eps) / LAM
    assert _rel(got, np.asarray(want), atol) <= RTOL
