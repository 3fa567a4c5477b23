"""The port's single-device dispatch ladder (deconv/dispatch.py) and its one
``resolve_algorithm`` against the JAX package's, on tests/test_dispatch.py's
problem: 2 views at (16, 8, 8), 3³ kernels, per-voxel weights 1/V.

Each rung is forced as tests/test_dispatch.py:54-72 forces it, by
monkeypatching ``device_capacity_bytes`` (and, on the JAX side, a device
count of 1: the JAX suite runs on 8 CPU devices, where JAX would take its
mesh rungs, which the port does not have).

Tolerance: 1e-5 of max|psi| against JAX's same rung.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libmultiviewnative_tpu.deconv import dispatch as jdispatch
from libmultiviewnative_tpu.deconv.workspace import MultiViewData as JaxData
from libmultiviewnative_torch.deconv import dispatch, rl, streamed
from libmultiviewnative_torch.interop import multiview_data_from_numpy
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (16, 8, 8)
V = 2


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (V,) + SHAPE).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((V,) + SHAPE, 1.0 / V, np.float32)
    return views, k1, k2, w


def _both(arrays):
    jdata = JaxData(*(jnp.asarray(a) for a in arrays))
    data = multiview_data_from_numpy(*arrays, device="cpu")
    psi0 = np.full(SHAPE, float(arrays[0].mean()), np.float32)
    return jdata, data, psi0


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _capacity(monkeypatch, nbytes):
    """Both packages believe the device holds ``nbytes``; JAX counts one
    device."""
    monkeypatch.setattr(jdispatch, "device_capacity_bytes", lambda device=None: nbytes)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: nbytes)


# tests/test_dispatch.py:297-317's shapes, on the CPU backend
@pytest.mark.parametrize("algorithm, shape", [
    ("auto", (256, 256, 256)), ("dft", (512, 512, 512)), ("auto", (512, 512, 512)),
    ("auto", (128, 128, 128)), ("auto", (300, 512, 512)), ("auto", (512, 512, 511)),
    ("auto", (16, 8, 8)), ("auto", (257, 8, 8)), ("fused", (16, 24, 32)),
], ids=str)
def test_resolve_algorithm_matches_jax_on_the_cpu(algorithm, shape):
    want = jdispatch.resolve_algorithm(algorithm, shape)
    assert rl.resolve_algorithm(algorithm, shape, "cpu") == want
    assert rl.resolve_algorithm(algorithm, shape, "cpu", chunk=True) == want
    with pytest.raises(ValueError, match="unknown algorithm"):
        rl.resolve_algorithm("dtf", shape, "cpu")


# the CUDA table (PERF.md §6; chip_smoke.py phase 22 on an H100): fused
# where every axis is at least 256, the CUDA passes serve the shape and it
# is of a class timed against fft, else fft, never dft; a streamed chunk is
# never fused
CUDA_TABLE = [
    ((64, 64, 64), "fft", "fft"),
    ((128, 128, 128), "fft", "fft"),
    ((256, 256, 256), "fused", "fft"),
    ((512, 512, 512), "fused", "fft"),
    ((32, 512, 512), "fft", "fft"),
    ((300, 512, 512), "fft", "fft"),
    ((256, 256, 1016), "fused", "fft"),  # a generic radix (127) within the widest tiles
    # past Z = 736 or X = 1816: fused 1.36x and 1.18x fft (PERF.md §6)
    ((1024, 512, 512), "fused", "fft"),
    ((256, 1024, 2048), "fused", "fft"),
    ((768, 256, 256), "fused", "fft"),  # 3·256, z tile 16
    ((256, 256, 3600), "fused", "fft"),  # 2^4·3^2·5^2, x tile 8
    # classes never timed against fft: a generic radix past X = 1816
    # (2008 = 8·251), tiles under 8 (X or Y of 3640), z tile 8 (Z = 1824)
    ((256, 256, 2008), "fft", "fft"),
    ((256, 256, 3640), "fft", "fft"),
    ((256, 3640, 256), "fft", "fft"),
    ((1824, 256, 256), "fft", "fft"),
]


@pytest.mark.parametrize("shape, incore, chunk", CUDA_TABLE, ids=str)
def test_resolve_algorithm_cuda_table(monkeypatch, shape, incore, chunk):
    """Pinned on the CPU: the device defaults to the card when one is there
    (the check monkeypatched), and an explicit CUDA device needs no card."""
    assert rl.resolve_algorithm("auto", shape, "cuda") == incore
    assert rl.resolve_algorithm("auto", shape, "cuda", chunk=True) == chunk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert rl.resolve_algorithm("auto", shape) == incore


# long axes, which the CUDA passes serve through HBM (four-step X = 16384,
# Bluestein X = 8248 = 8·1031): chip_smoke.py's phase 30 main path, and the
# same x lengths with every axis at least 256
LONG_AXES = [(64, 512, 16384), (64, 512, 8248), (256, 256, 16384), (256, 256, 8248)]


@pytest.mark.parametrize("shape", LONG_AXES, ids=str)
def test_auto_keeps_fft_at_the_long_axes(shape):
    """The fused engine serves a long axis on the card (``fused_eligible``),
    and ``auto`` still takes fft there: no such class was timed against fft
    (``_fused_timed``)."""
    assert rl.fused_eligible(shape, torch.device("cuda"))
    assert not rl._fused_timed(shape)
    assert rl.resolve_algorithm("auto", shape, "cuda") == "fft"
    assert rl.resolve_algorithm("auto", shape, "cuda", chunk=True) == "fft"


@pytest.mark.parametrize("algorithm", ["fft", "dft", "fused", "direct", "auto"])
def test_estimates_match_jax(algorithm):
    jdata, data, _ = _both(_arrays())
    assert dispatch.estimate_workspace_bytes(data, algorithm, "cpu") == \
        jdispatch.estimate_workspace_bytes(jdata, algorithm)
    assert dispatch.estimate_interleaved_bytes(data, algorithm, "cpu") == \
        jdispatch.estimate_interleaved_bytes(jdata, algorithm)
    assert dispatch.device_capacity_bytes("cpu") == 16 * 1024**3


def _rung_cap(data, rung, algorithm):
    est = dispatch.estimate_workspace_bytes(data, algorithm, "cpu")
    est_il = dispatch.estimate_interleaved_bytes(data, algorithm, "cpu")
    assert est_il < est
    return {"in-core": 16 * 1024**3, "interleaved": int((est_il + est) / 2 / 0.9) + 1,
            "streamed": 1}[rung]


@pytest.mark.parametrize("rung", ["in-core", "interleaved", "streamed"])
@pytest.mark.parametrize("algorithm", ["auto", "fft", "dft"])
def test_each_rung_matches_jax(monkeypatch, capsys, rung, algorithm):
    jdata, data, psi0 = _both(_arrays())
    _capacity(monkeypatch, _rung_cap(data, rung, algorithm))
    monkeypatch.setenv("LMVN_TRACE", "1")
    kw = dict(lam=0.006, algorithm=algorithm, chunk_z=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, device="cpu", **kw)
    assert f"dispatch: {rung} on one device" in capsys.readouterr().out
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, **kw)
    assert _rel(got.numpy(), want) <= TOL


def test_streamed_rung_honours_adjoint_kernel2(monkeypatch):
    """A poisoned kernel2 stays ignored when the ladder falls to the
    streamed rung (tests/test_dispatch.py:242-270)."""
    views, k1, _, w = _arrays()
    poisoned = np.ones_like(k1) / k1[0].size
    jdata, data, psi0 = _both((views, k1, poisoned, w))
    _capacity(monkeypatch, 1)
    kw = dict(adjoint_kernel2=True, chunk_z=8, algorithm="fft")
    got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, device="cpu", **kw)
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, **kw)
    assert _rel(got.numpy(), want) <= TOL
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, adjoint_kernel2=True, algorithm="fft")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="odd kernel1 dims"):
        dispatch.deconvolve_auto(torch.from_numpy(psi0), multiview_data_from_numpy(
            views, np.zeros((V, 4, 3, 3), np.float32), poisoned, w, device="cpu"), 1,
            adjoint_kernel2=True, device="cpu")


def test_divergence_and_strict(monkeypatch):
    """An engine or view order a rung cannot honour warns (JAX's
    DispatchDivergenceWarning contract) or, with ``strict``, raises; an
    explicit fused request on the interleaved rung passes silently."""
    jdata, data, psi0 = _both(_arrays())
    psi = torch.from_numpy(psi0)
    _capacity(monkeypatch, 1)
    with pytest.warns(dispatch.DispatchDivergenceWarning, match="streamed rung"):
        got = dispatch.deconvolve_auto(psi, data, 2, algorithm="fused", chunk_z=8, device="cpu")
    with pytest.warns(jdispatch.DispatchDivergenceWarning):
        want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, algorithm="fused", chunk_z=8)
    assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        dispatch.deconvolve_auto(psi, data, 1, view_order="simultaneous", strict=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 1, view_order="simultaneous",
                                  strict=True)
    _capacity(monkeypatch, _rung_cap(data, "interleaved", "fused"))
    with pytest.raises(ValueError, match="interleaved rung"):
        dispatch.deconvolve_auto(psi, data, 1, algorithm="fused", view_order="simultaneous",
                                 strict=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(psi, data, 2, algorithm="fused", chunk_z=8, device="cpu")
    incore = rl.deconvolve(psi, data, 2, algorithm="fused")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=2e-5, atol=2e-4)


def test_direct_request_skips_the_interleaved_rung(monkeypatch):
    """The interleaved rung is skipped for an explicit "direct" request,
    which the streamed rung honours (its chunks run the direct engine)."""
    _, data, psi0 = _both(_arrays())
    _capacity(monkeypatch, _rung_cap(data, "interleaved", "direct"))
    seen = []
    monkeypatch.setattr(dispatch, "deconvolve_interleaved",
                        lambda *a, **k: seen.append("interleaved"))
    real = streamed._convolver
    monkeypatch.setattr(streamed, "_convolver",
                        lambda *a: seen.append(a[2]) or real(*a))
    got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 1, algorithm="direct",
                                   chunk_z=8, device="cpu")
    assert seen and set(seen) == {"direct"}
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 1, algorithm="direct")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)


# ---- the mesh rungs.  JAX takes them on its 8 virtual CPU devices; the
# port is told of 8 devices and given CPU cells (its count and cells are
# module-level helpers, as JAX's tests patch jax.device_count) ----


def _mesh_fleet(monkeypatch, capacity):
    """Both packages believe each device holds ``capacity`` bytes and see 8
    devices; the port's cells are CPUs."""
    assert jax.device_count() == 8
    monkeypatch.setattr(jdispatch, "device_capacity_bytes", lambda device=None: capacity)
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: capacity)
    monkeypatch.setattr(dispatch, "mesh_device_count", lambda: 8)
    monkeypatch.setattr(dispatch, "mesh_devices", lambda n: ["cpu"] * n)


def _est(data, algorithm="auto"):
    return dispatch.estimate_workspace_bytes(data, algorithm, "cpu")


def test_mesh_device_count_on_a_host_without_a_card():
    assert dispatch.mesh_device_count() == 0


def test_auto_sequential_routes_to_zonly_mesh(monkeypatch, capsys):
    """A sequential request too big for one device runs the reference's
    view loop on a z-only mesh (tests/test_dispatch.py:122-144): no
    divergence, the in-core sequential result."""
    jdata, data, psi0 = _both(_arrays())
    _mesh_fleet(monkeypatch, _est(data) // 4)
    monkeypatch.setenv("LMVN_TRACE", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        warnings.simplefilter("error", jdispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, lam=0.006, device="cpu")
        want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, lam=0.006)
    out = capsys.readouterr().out
    assert "dispatch: sequential parity on z-only mesh {'view': 1, 'z': 8}" in out
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _rel(got.numpy(), want) <= TOL
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, lam=0.006, algorithm="dft")
    assert _rel(got.numpy(), incore.numpy()) <= TOL


@pytest.mark.parametrize("algorithm", ["auto", "dft"])
def test_auto_sharded_rung_matches(monkeypatch, capsys, algorithm):
    """No z-only factorization: the view-sharded mesh runs the simultaneous
    order and warns for a sequential request (tests/test_dispatch.py:
    147-204); the requested engine is honoured."""
    jdata, data, psi0 = _both(_arrays())
    _mesh_fleet(monkeypatch, _est(data) // 4)
    monkeypatch.setattr(dispatch, "_pick_zonly_mesh", lambda *a, **k: None)
    monkeypatch.setattr(jdispatch, "_pick_zonly_mesh", lambda *a, **k: None)
    monkeypatch.setenv("LMVN_TRACE", "1")
    with pytest.warns(dispatch.DispatchDivergenceWarning, match="SIMULTANEOUS"):
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, lam=0.006,
                                       algorithm=algorithm, device="cpu")
    assert "dispatch: sharded mesh {'view': 2, 'z': 4}" in capsys.readouterr().out
    with pytest.warns(jdispatch.DispatchDivergenceWarning):
        want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, lam=0.006,
                                         algorithm=algorithm)
    assert _rel(got.numpy(), want) <= TOL
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, lam=0.006,
                           view_order="simultaneous", algorithm="fft")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="SIMULTANEOUS"):
        dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 1, strict=True, device="cpu")


def test_simultaneous_request_on_the_mesh_and_the_weight_audit(monkeypatch):
    """A simultaneous request takes the view-sharded mesh silently; a
    sequential one sent there runs the weight audit first
    (tests/test_dispatch.py:426-457)."""
    jdata, data, psi0 = _both(_arrays())
    _mesh_fleet(monkeypatch, _est(data) // 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2,
                                       view_order="simultaneous", device="cpu")
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, view_order="simultaneous")
    assert _rel(got.numpy(), want) <= TOL
    from libmultiviewnative_torch.deconv.workspace import WeightNormalizationWarning

    views, k1, k2, _ = _arrays()
    bad = multiview_data_from_numpy(views, k1, k2, np.ones_like(views), device="cpu")
    monkeypatch.setattr(dispatch, "_pick_zonly_mesh", lambda *a, **k: None)
    with pytest.warns(WeightNormalizationWarning):
        with pytest.warns(dispatch.DispatchDivergenceWarning):
            dispatch.deconvolve_auto(torch.from_numpy(psi0), bad, 1, device="cpu")


def test_r1_sequential_request_the_zonly_mesh_cannot_run(monkeypatch, capsys):
    """R1 (ROADMAP queue 3): a sequential "direct" request where a z-only
    mesh exists.  JAX demotes it to the simultaneous view-sharded mesh (a
    divergence warning, simultaneous math); the port goes on to the
    sequential off-core rungs, which run both the order and the engine."""
    jdata, data, psi0 = _both(_arrays())
    _mesh_fleet(monkeypatch, _est(data, "direct") // 4)
    monkeypatch.setenv("LMVN_TRACE", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("error", dispatch.DispatchDivergenceWarning)
        got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, algorithm="direct",
                                       chunk_z=8, device="cpu")
    out = capsys.readouterr().out
    assert "z-only mesh cannot honour algorithm='direct'" in out
    assert "dispatch: streamed on one device" in out and "sharded mesh" not in out
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, algorithm="direct")
    np.testing.assert_allclose(got.numpy(), incore.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.warns(jdispatch.DispatchDivergenceWarning):
        want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, algorithm="direct",
                                         chunk_z=8)
    assert "dispatch: sharded mesh" in capsys.readouterr().out
    assert _rel(got.numpy(), want) > 1e-3  # JAX ran the simultaneous order


def test_r2_zonly_mesh_counts_what_every_cell_holds(monkeypatch):
    """R2 (ROADMAP queue 3): JAX admits a z-only mesh when est < cap * zp,
    as if the spectra were split over the cells; every cell holds all views'
    spectra at its halo-extended extent.  At a capacity between the two
    counts JAX picks an 8-cell mesh and the port none."""
    jdata, data, _ = _both(_arrays())
    vol = 4 * int(np.prod(SHAPE))
    est = _est(data)
    assert est == 16 * vol  # 2V views and weights, 2V spectra, 8 temporaries
    # one of 8 cells: 12 volumes / 8, spectra 4 volumes * (2 + 2) / 16 planes
    assert dispatch._zonly_cell_bytes(data, "auto", 8, "cpu") == 12 * vol // 8 + vol + 4 * 2 * V * 27
    cap = int(2.25 * vol)
    jmesh = jdispatch._pick_zonly_mesh(SHAPE[0], 8, 1, jdispatch.estimate_workspace_bytes(jdata),
                                       cap)
    assert jmesh is not None and jmesh.shape["z"] == 8
    monkeypatch.setattr(dispatch, "mesh_devices", lambda n: ["cpu"] * n)
    assert dispatch._pick_zonly_mesh(data, "auto", 8, 1, cap, "cpu") is None
    mesh = dispatch._pick_zonly_mesh(data, "auto", 8, 1, 3 * vol, "cpu")
    assert mesh is not None and mesh.shape == {"view": 1, "z": 8}


def test_mesh_factorization_falls_back_to_stream(monkeypatch, capsys):
    """V=2 views and Z=15 on 8 devices: no ('view', 'z') factorization, so
    the ladder streams (tests/test_dispatch.py:260-278)."""
    views, k1, k2, w = _arrays()
    arrays = (views[:, :15], k1, k2, w[:, :15])
    jdata, data, psi0 = _both_shape(arrays)
    _mesh_fleet(monkeypatch, _est(data) // 2)
    monkeypatch.setattr(dispatch, "_pick_zonly_mesh", lambda *a, **k: None)
    monkeypatch.setenv("LMVN_TRACE", "1")
    got = dispatch.deconvolve_auto(torch.from_numpy(psi0), data, 2, chunk_z=5, algorithm="fft",
                                   device="cpu")
    out = capsys.readouterr().out
    assert "no valid mesh factorization" in out and "dispatch: streamed" in out
    incore = rl.deconvolve(torch.from_numpy(psi0), data, 2, algorithm="fft")
    assert _rel(got.numpy(), incore.numpy()) <= TOL
    monkeypatch.setattr(jdispatch, "_pick_zonly_mesh", lambda *a, **k: None)
    want = jdispatch.deconvolve_auto(jnp.asarray(psi0), jdata, 2, chunk_z=5, algorithm="fft")
    assert _rel(got.numpy(), want) <= TOL


def _both_shape(arrays):
    arrays = tuple(np.ascontiguousarray(a) for a in arrays)
    jdata = JaxData(*(jnp.asarray(a) for a in arrays))
    data = multiview_data_from_numpy(*arrays, device="cpu")
    psi0 = np.full(arrays[0].shape[1:], float(arrays[0].mean()), np.float32)
    return jdata, data, psi0


@pytest.mark.parametrize("elementwise", ["jnp", "pallas"])
def test_each_entry_point_takes_elementwise(elementwise):
    """F8: every entry point takes JAX's ``elementwise``; both values run K1."""
    from libmultiviewnative_torch.deconv.interleaved import deconvolve_interleaved

    views, k1, k2, w = _arrays()
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    psi0 = torch.from_numpy(np.full(SHAPE, float(views.mean()), np.float32))
    want = rl.deconvolve(psi0, data, 1, lam=0.006).numpy()
    got = [
        rl.deconvolve(psi0, data, 1, 0.006, 1e-4, "sequential", "fft", False, elementwise),
        rl.deconvolve_prepared(psi0, data, rl.prepare_workspace(data, SHAPE, "fft"), 1, 0.006,
                               1e-4, "sequential", elementwise),
        dispatch.deconvolve_auto(psi0, data, 1, lam=0.006, algorithm="fft",
                                 elementwise=elementwise, device="cpu"),
        deconvolve_interleaved(psi0, list(views), list(k1), list(k2), list(w), 1, lam=0.006,
                               algorithm="fft", elementwise=elementwise, device="cpu"),
        streamed.deconvolve_streamed(psi0, list(views), list(k1), list(k2), list(w), 1, 0.006,
                                     1e-4, chunk_z=8, elementwise=elementwise, device="cpu"),
    ]
    for g in got:
        np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-4)


def test_each_entry_point_refuses_an_unknown_elementwise():
    from libmultiviewnative_torch.deconv.interleaved import deconvolve_interleaved

    views, k1, k2, w = _arrays()
    data = multiview_data_from_numpy(views, k1, k2, w, device="cpu")
    psi0 = torch.from_numpy(np.full(SHAPE, float(views.mean()), np.float32))
    calls = [
        lambda: rl.deconvolve(psi0, data, 1, elementwise="xla"),
        lambda: rl.deconvolve_prepared(psi0, data, rl.prepare_workspace(data, SHAPE, "fft"), 1,
                                       elementwise="xla"),
        lambda: dispatch.deconvolve_auto(psi0, data, 1, elementwise="xla", device="cpu"),
        lambda: deconvolve_interleaved(psi0, list(views), list(k1), list(k2), list(w), 1,
                                       elementwise="xla", device="cpu"),
        lambda: streamed.deconvolve_streamed(psi0, list(views), list(k1), list(k2), list(w), 1,
                                             elementwise="xla", device="cpu"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unknown elementwise"):
            call()
    with pytest.raises(ValueError, match="unknown elementwise"):
        jdispatch.deconvolve_auto(jnp.asarray(psi0.numpy()), JaxData(
            *(jnp.asarray(a) for a in (views, k1, k2, w))), 1, elementwise="xla")
