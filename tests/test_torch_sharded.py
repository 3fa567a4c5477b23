"""The port's mesh deconvolution (parallel/sharded.py) against the JAX package's
``deconvolve_sharded``, on the cases of tests/test_sharded.py.

JAX runs on its 8 virtual CPU devices; the port on a mesh of CPU cells in
one process (a device may repeat in ``make_mesh``'s list).  The same numpy
inputs, from a seed, go through both.  Tolerances as JAX's own: rms < 1e-4
and rtol/atol 5e-3 for the simultaneous order, rms < 1e-5 (5e-5 on the dft
and fused engines) for the sequential one.  The fused engine is held against JAX's
Pallas interpret mode at 16³ (two cases; interpret mode is slow) and
against the port's single-device fused engine at the larger shapes.  The
fold-x and split-x cases of tests/test_sharded.py are not here: those x
modes are not ported.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.deconv.rl import deconvolve_jit as jax_deconvolve_jit
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_tpu.parallel import sharded as jsharded
from libmultiviewnative_torch.deconv.rl import deconvolve
from libmultiviewnative_torch.deconv.workspace import MultiViewData, WeightNormalizationWarning
from libmultiviewnative_torch.parallel import sharded
from libmultiviewnative_torch.parallel.sharded import (
    MeshTensor,
    deconvolve_sharded,
    make_mesh,
    shard_workspace,
)
from libmultiviewnative_torch.reference.oracle import rms
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_plan_caches():
    """The JAX references here run ``deconvolve_sharded`` eagerly, so the DFT
    plans the JAX package caches (``core.dft.make_plan``,
    ``_cached_axis_plan``) are first built inside a shard_map trace and keep
    its tracers; a later jitted mesh call in the same process (as in
    tests/test_dispatch.py) then fails on them.  Drop those plans when this
    module is done."""
    yield
    from libmultiviewnative_tpu.core import dft as jdft

    jdft.make_plan.cache_clear()
    jdft._cached_axis_plan.cache_clear()


def _arrays(num_views=4, shape=(16, 8, 8), seed=5, kshape=(3, 3, 3), sigma0=0.8,
            scalar_weights=False):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (num_views,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel(kshape, sigma0 + 0.2 * v) for v in range(num_views)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = (np.full((num_views,), 1.0 / num_views, np.float32) if scalar_weights
         else np.full((num_views,) + shape, 1.0 / num_views, np.float32))
    return views, k1, k2, w


def _data(arrays):
    return MultiViewData(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def _jdata(arrays):
    return JaxData(*(jnp.asarray(a) for a in arrays))


def _psi0(arrays):
    return np.full(arrays[0].shape[1:], float(arrays[0].mean()), np.float32)


def _cpu_mesh(vp, zp):
    return make_mesh(view_parallel=vp, z_parallel=zp, devices=["cpu"] * (vp * zp))


def _port(arrays, vp, zp, iters, **kw):
    mesh = _cpu_mesh(vp, zp)
    psi_s, data_s = shard_workspace(_data(arrays), torch.from_numpy(_psi0(arrays)), mesh)
    out = deconvolve_sharded(psi_s, data_s, iters, mesh, **kw)
    assert isinstance(out, MeshTensor) and out.partition == ("z",)
    got = out.full().numpy()
    assert np.isfinite(got).all()
    return got


def _jax_sharded(arrays, vp, zp, iters, **kw):
    mesh = jsharded.make_mesh(view_parallel=vp, z_parallel=zp,
                              devices=np.asarray(jax.devices()[: vp * zp]))
    psi_s, data_s = jsharded.shard_workspace(_jdata(arrays), jnp.asarray(_psi0(arrays)), mesh)
    return np.asarray(jsharded.deconvolve_sharded(psi_s, data_s, iters, mesh, **kw))


def _jax_single(arrays, iters, **kw):
    return np.asarray(jax_deconvolve_jit(jnp.asarray(_psi0(arrays)), _jdata(arrays), iters, **kw))


def _close(got, want, tol=1e-4):
    assert rms(got, want) < tol, rms(got, want)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("vp,zp", [(1, 8), (4, 2), (2, 4)])
def test_sharded_matches_jax_simultaneous(vp, zp):
    arrays = _arrays()
    got = _port(arrays, vp, zp, 2)
    _close(got, _jax_sharded(arrays, vp, zp, 2))
    _close(got, _jax_single(arrays, 2, view_order="simultaneous"))


def test_sharded_rejects_undivisible():
    arrays = _arrays(num_views=3)
    mesh = _cpu_mesh(2, 4)
    with pytest.raises(ValueError, match="views not divisible"):
        deconvolve_sharded(torch.zeros(16, 8, 8), _data(arrays), 1, mesh)
    arrays = _arrays(num_views=2, shape=(15, 8, 8))
    with pytest.raises(ValueError, match="not divisible by z axis"):
        deconvolve_sharded(torch.zeros(15, 8, 8), _data(arrays), 1, mesh)
    with pytest.raises(ValueError, match="2x3 mesh != 8 devices"):
        make_mesh(2, 3, devices=["cpu"] * 8)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_sharded_bz_equals_halo_boundary(algorithm):
    """Every block exactly one halo wide (bz 2, kernel z 5): each convolve's
    extent is three blocks and every halo plane crosses a cell boundary."""
    arrays = _arrays(num_views=2, seed=7, kshape=(5, 3, 3))
    got = _port(arrays, 1, 8, 2, algorithm=algorithm)
    want = _jax_single(arrays, 2, view_order="simultaneous")
    assert rms(got, want) < 1e-4
    assert rms(got, _jax_sharded(arrays, 1, 8, 2, algorithm=algorithm)) < 1e-4


def test_sharded_bz_below_halo_raises():
    views, _, _, w = _arrays()
    k = np.stack([gaussian_kernel((7, 7, 7), 1.0) for _ in range(4)])
    mesh = _cpu_mesh(1, 8)
    with pytest.raises(ValueError, match="smaller than PSF halo"):
        deconvolve_sharded(torch.zeros(16, 8, 8), _data((views, k, k, w)), 1, mesh)


@pytest.mark.parametrize("algorithm", ["dft", "auto"])
def test_sharded_dft_engine_matches_fft(algorithm):
    arrays = _arrays()
    a = _port(arrays, 2, 4, 2, algorithm="fft")
    b = _port(arrays, 2, 4, 2, algorithm=algorithm)
    assert rms(a, b) < 1e-4
    assert rms(b, _jax_sharded(arrays, 2, 4, 2, algorithm=algorithm)) < 1e-4


def test_sharded_rejects_unsupported_engine():
    arrays = _arrays(num_views=2)
    mesh = _cpu_mesh(2, 4)
    for bad in ("direct", "dtf"):
        with pytest.raises(ValueError, match="sharded rung supports"):
            deconvolve_sharded(torch.full((16, 8, 8), 100.0), _data(arrays), 1, mesh,
                               algorithm=bad)
    with pytest.raises(ValueError, match="unknown elementwise"):
        deconvolve_sharded(torch.full((16, 8, 8), 100.0), _data(arrays), 1, mesh,
                           elementwise="cuda")


# ---- the fused engine on the mesh: against JAX's interpret mode at 16³ ----


@pytest.mark.parametrize("vp,zp,num_views", [(4, 1, 4), (2, 4, 2)], ids=["view-only", "zblock"])
def test_sharded_fused_matches_jax_interpret(vp, zp, num_views):
    """z axis 1: the whole fused step per cell (K4, K6, K8, K6, K9); z axis
    > 1: overlap-save fused convolves at the 8-aligned extent (3³ kernel:
    extent 6, padded 8)."""
    shape = (16, 16, 16)
    arrays = _arrays(num_views, shape, seed=9)
    got = _port(arrays, vp, zp, 2, algorithm="fused")
    _close(got, _jax_sharded(arrays, vp, zp, 2, algorithm="fused"))
    _close(got, _jax_single(arrays, 2, view_order="simultaneous"))


def _vs_port_single(arrays, vp, zp, iters, tol=1e-4):
    got = _port(arrays, vp, zp, iters, algorithm="fused")
    data = _data(arrays)
    want = deconvolve(torch.from_numpy(_psi0(arrays)), data, iters, view_order="simultaneous",
                      algorithm="fused").numpy()
    assert rms(got, want) < tol, rms(got, want)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    return got


@pytest.mark.parametrize("shape, vp, zp, iters, scalar", [
    ((16, 16, 16), 2, 4, 2, True),     # scalar weights, z blocks
    ((16, 128, 128), 2, 4, 1, False),  # wide lanes
    ((16, 136, 16), 2, 4, 1, False),   # Y a multiple of 8 but not of 128
    ((16, 16, 16), 4, 1, 2, True),     # scalar weights, one z block
], ids=["zblock-scalar-weights", "wide-lanes", "misaligned-y", "view-only-scalar-weights"])
def test_sharded_fused_matches_single_device(shape, vp, zp, iters, scalar):
    arrays = _arrays(2 if zp > 1 else 4, shape, seed=9, scalar_weights=scalar)
    _vs_port_single(arrays, vp, zp, iters)


def test_sharded_fused_rejects_ineligible_geometry():
    arrays = _arrays(2, (16, 8, 9), seed=9)
    mesh = _cpu_mesh(2, 4)
    psi_s, data_s = shard_workspace(_data(arrays), torch.zeros(16, 8, 9), mesh)
    with pytest.raises(ValueError, match="fused engine requires"):
        deconvolve_sharded(psi_s, data_s, 1, mesh, algorithm="fused")


def test_sharded_auto_never_fused_on_cpu():
    mesh = _cpu_mesh(2, 4)
    assert not sharded.sharded_fused_eligible((256, 256, 256), mesh)
    assert sharded._mesh_algorithm("auto", (256, 256, 256), mesh, 280, 24) == "fft"
    assert sharded._mesh_algorithm("auto", (16, 8, 8), mesh, 10, 2) == "dft"


@pytest.mark.parametrize("mesh_shape, spatial, halo, eligible, auto", [
    ((1, 4), (256, 256, 256), 24, True, "fused"),      # z blocks 64 -> extent 88
    ((4, 1), (256, 256, 256), 24, True, "fused"),      # whole volume per cell
    ((1, 2), (512, 512, 512), 24, True, "fused"),      # extent 280
    ((1, 1), (1024, 512, 512), 24, True, "fused"),     # extent 1048, past the old 736
    ((1, 2), (1024, 512, 512), 24, True, "fused"),     # extent 536
    ((1, 1), (256, 256, 3640), 24, True, "fft"),       # x tile 4: never timed against fft
    ((1, 2), (2048, 256, 256), 24, True, "fft"),       # extent 1048 = 8·131 past Z = 736
    ((1, 4), (128, 128, 128), 24, True, "fft"),        # extent 56: under 256
    ((1, 4), (256, 256, 260), 24, False, "fft"),       # X not a multiple of 8
], ids=str)
def test_sharded_auto_on_a_cuda_mesh(mesh_shape, spatial, halo, eligible, auto):
    """The CUDA rule, pinned here (building a mesh of CUDA cells needs no
    card): fused where eligible at the local extent, ext_max >= 256 and the
    local shape of a class timed against fft, else fft, never dft."""
    vp, zp = mesh_shape
    mesh = make_mesh(vp, zp, devices=["cuda:0"] * (vp * zp))
    assert sharded.sharded_fused_eligible(spatial, mesh, halo) == eligible
    bz = spatial[0] // zp
    ext_max = max(bz + halo, spatial[1], spatial[2])
    assert sharded._mesh_algorithm("auto", spatial, mesh, ext_max, halo) == auto


# ---- the sequential (reference-parity) order on a z-only mesh ----


def _seq_arrays(num_views=3, shape=(16, 16, 16), seed=13):
    return _arrays(num_views, shape, seed=seed, kshape=(5, 5, 5), sigma0=0.9)


@pytest.mark.parametrize("algorithm", ["fft", "dft", "fused"])
def test_sharded_sequential_matches_parity_math(algorithm):
    arrays = _seq_arrays()
    got = _port(arrays, 1, 4, 3, lam=0.006, algorithm=algorithm, view_order="sequential")
    want = _jax_single(arrays, 3, lam=0.006, view_order="sequential", algorithm="fft")
    # JAX's bars: 1e-5, and 5e-5 for the dft engine's transforms at the
    # halo-extended extents.  The port's fused passes on the CPU are another
    # fp32 factorisation of the DFT: its single-device fused engine is
    # itself 1.1e-5 from JAX's fft result here, so it takes the dft bar.
    tol = 1e-5 if algorithm == "fft" else 5e-5
    assert rms(got, want) < tol, rms(got, want)
    if algorithm != "fused":
        jgot = _jax_sharded(arrays, 1, 4, 3, lam=0.006, algorithm=algorithm,
                            view_order="sequential")
        assert rms(got, jgot) < tol, rms(got, jgot)


def test_sharded_sequential_differs_from_simultaneous():
    arrays = _seq_arrays()
    seq = _port(arrays, 1, 4, 3, lam=0.006, view_order="sequential")
    sim = _port(arrays, 1, 4, 3, lam=0.006, view_order="simultaneous")
    assert rms(seq, sim) > 1e-4


def test_sharded_sequential_requires_zonly_mesh():
    arrays = _seq_arrays(num_views=4)
    mesh = _cpu_mesh(2, 4)
    with pytest.raises(ValueError, match="z-only mesh"):
        deconvolve_sharded(torch.zeros(16, 16, 16), _data(arrays), 1, mesh,
                           view_order="sequential")
    with pytest.raises(ValueError, match="unknown view_order"):
        deconvolve_sharded(torch.zeros(16, 16, 16), _data(arrays), 1, mesh, view_order="random")


def test_sharded_sequential_scalar_weights_and_tikhonov():
    V, shape = 2, (16, 16, 16)
    rng = np.random.default_rng(17)
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)])
    arrays = (views, k1, np.flip(k1, axis=(1, 2, 3)).copy(), np.full((V,), 1.0 / V, np.float32))
    got = _port(arrays, 1, 8, 2, lam=0.01, view_order="sequential")
    want = _jax_single(arrays, 2, lam=0.01, view_order="sequential")
    assert rms(got, want) < 1e-5, rms(got, want)
    jgot = _jax_sharded(arrays, 1, 8, 2, lam=0.01, view_order="sequential")
    assert rms(got, jgot) < 1e-5, rms(got, jgot)


# ---- the port's own surface: layouts, plain tensors, the weight audit ----


def test_psi_comes_back_as_it_came():
    """A plain psi (and plain data) comes back as a plain tensor; a
    MeshTensor as a MeshTensor, its blocks at the global indices of
    ``local_shards``, and the caller's blocks unwritten."""
    arrays = _arrays()
    mesh = _cpu_mesh(2, 4)
    psi0 = torch.from_numpy(_psi0(arrays))
    plain = deconvolve_sharded(psi0.clone(), _data(arrays), 2, mesh)
    assert isinstance(plain, torch.Tensor) and plain.shape == psi0.shape
    psi_s, data_s = shard_workspace(_data(arrays), psi0, mesh)
    before = {c: b.clone() for c, b in psi_s.blocks.items()}
    out = deconvolve_sharded(psi_s, data_s, 2, mesh)
    np.testing.assert_array_equal(out.full().numpy(), plain.numpy())
    for s in out.local_shards():
        np.testing.assert_array_equal(s.data.numpy(), plain.numpy()[s.index])
        assert s.index[0] == slice(4 * s.cell[1], 4 * s.cell[1] + 4)
    for c, b in psi_s.blocks.items():
        torch.testing.assert_close(b, before[c], rtol=0, atol=0)
    assert [s.index[0] for s in data_s.views.local_shards()][:2] == [slice(0, 2), slice(0, 2)]
    assert data_s.kernel1.index((1, 3)) == (slice(2, 4), slice(0, 3), slice(0, 3), slice(0, 3))


def test_simultaneous_weight_audit_warns():
    views, k1, k2, _ = _arrays()
    w = np.ones((4, 16, 8, 8), np.float32)  # sums to 4 over the views
    mesh = _cpu_mesh(2, 4)
    with pytest.warns(WeightNormalizationWarning):
        deconvolve_sharded(torch.full((16, 8, 8), 50.0), _data((views, k1, k2, w)), 1, mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("error", WeightNormalizationWarning)
        deconvolve_sharded(torch.full((16, 8, 8), 50.0), _data(_arrays()), 1, mesh)


def test_make_mesh_needs_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    mesh = make_mesh(2, devices=np.asarray(["cpu"] * 4))
    assert mesh.shape == {"view": 2, "z": 2} and mesh.all_local


def test_deconvolve_sharded_jit_is_deconvolve_sharded():
    arrays = _arrays()
    mesh = _cpu_mesh(2, 4)
    psi0 = torch.from_numpy(_psi0(arrays))
    a = sharded.deconvolve_sharded_jit(psi0, _data(arrays), 1, mesh, lam=0.006)
    b = deconvolve_sharded(psi0, _data(arrays), 1, mesh, lam=0.006)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
