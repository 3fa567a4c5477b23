"""The port's block-wise loader (parallel/loader.py) on the cases of
tests/test_loader.py, against the JAX package's loader and ``deconvolve_sharded`` on its 8
virtual CPU devices.

Loaded blocks are bitwise the whole-tensor layout of ``shard_workspace``;
the flat-average psi0 agrees to 2e-6 relative; ``deconvolve_sharded``'s results on the
loaded and the laid-out workspace to 1e-5, and the port's against JAX's
``deconvolve_sharded`` on JAX's loaded workspace to rms 1e-4 (the
simultaneous bar of tests/test_sharded.py).
"""

import jax
import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.parallel import loader as jloader
from libmultiviewnative_tpu.parallel import sharded as jsharded
from libmultiviewnative_torch.deconv.workspace import MultiViewData
from libmultiviewnative_torch.io.stacks import save_stack_h5, save_stack_npz, write_tiff_stack
from libmultiviewnative_torch.parallel.loader import (
    as_reader,
    load_sharded_workspace,
    make_sharded_stack,
)
from libmultiviewnative_torch.parallel.sharded import deconvolve_sharded, make_mesh, shard_workspace
from libmultiviewnative_torch.reference.oracle import rms
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

V, SHAPE = 4, (16, 8, 8)


def _problem(seed=7):
    rng = np.random.default_rng(seed)
    views = [rng.gamma(2.0, 10.0, SHAPE).astype(np.float32) for _ in range(V)]
    k1 = [gaussian_kernel((3, 3, 3), 0.8 + 0.2 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    ws = [np.full(SHAPE, 1.0 / V, np.float32) for _ in range(V)]
    return views, k1, k2, ws


def _mesh(vp, zp):
    return make_mesh(view_parallel=vp, z_parallel=zp, devices=["cpu"] * (vp * zp))


def _recording(readers):
    calls = []

    def wrap(r, v):
        def inner(zs):
            calls.append((v, zs.indices(SHAPE[0])))
            return r(zs)

        return inner

    return [wrap(r, v) for v, r in enumerate(readers)], calls


def test_loaded_equals_shard_workspace():
    views, k1, k2, ws = _problem()
    mesh = _mesh(4, 2)
    psi0 = np.full(SHAPE, float(np.mean(np.stack(views))), np.float32)
    psi_l, data_l = load_sharded_workspace(mesh, views, k1, k2, ws, SHAPE)
    data = MultiViewData(*(torch.from_numpy(np.stack(a)) for a in (views, k1, k2, ws)))
    psi_d, data_d = shard_workspace(data, torch.from_numpy(psi0), mesh)
    np.testing.assert_allclose(psi_l.full().numpy(), psi0, rtol=2e-6)
    for name in ("views", "kernel1", "kernel2", "weights"):
        got, want = getattr(data_l, name), getattr(data_d, name)
        assert got.partition == want.partition
        np.testing.assert_array_equal(got.full().numpy(), want.full().numpy())
    out = deconvolve_sharded(psi_l, data_l, 2, mesh, lam=0.006).full().numpy()
    ref = deconvolve_sharded(psi_d, data_d, 2, mesh, lam=0.006).full().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # and JAX's loader and deconvolve_sharded on the same sources
    jmesh = jsharded.make_mesh(view_parallel=4, z_parallel=2)
    jpsi, jdata = jloader.load_sharded_workspace(jmesh, views, k1, k2, ws, SHAPE)
    want = np.asarray(jsharded.deconvolve_sharded(jpsi, jdata, 2, jmesh, lam=0.006))
    assert rms(out, want) < 1e-4


def test_reads_are_slabwise():
    views, _, _, _ = _problem()
    mesh = _mesh(2, 4)
    readers, calls = _recording([as_reader(v) for v in views])
    make_sharded_stack(mesh, readers, SHAPE)
    assert sorted(v for v, _ in calls) == sorted(list(range(V)) * 4)
    for v, (z0, z1, _) in calls:
        assert z1 - z0 == SHAPE[0] // 4, f"read ({z0},{z1}) is not a z/4 slab"


def test_cells_on_one_device_share_a_read():
    """A stack replicated over 'view' (cells (0, z) and (1, z) hold the same
    block): one read per block and device, as JAX dedups shard indices."""
    views, _, _, _ = _problem()
    mesh = _mesh(2, 4)
    readers, calls = _recording([as_reader(v) for v in views])
    st = make_sharded_stack(mesh, readers, SHAPE, spec=(None, "z"))
    assert len(calls) == V * 4
    assert st.blocks[(0, 1)] is st.blocks[(1, 1)]
    np.testing.assert_array_equal(st.full().numpy(), np.stack(views))


def test_h5_and_scalar_weights_sources(tmp_path):
    views, k1, k2, _ = _problem()
    srcs = []
    for v, arr in enumerate(views):
        p = tmp_path / f"view_{v}.h5"
        save_stack_h5(str(p), chunks_z=4, view=arr)
        srcs.append(f"{p}:view")
    mesh = _mesh(4, 2)
    psi, data = load_sharded_workspace(mesh, srcs, k1, k2, [1.0 / V] * V, SHAPE)
    np.testing.assert_array_equal(data.views.full().numpy(), np.stack(views))
    assert tuple(data.weights.shape) == (V,) and data.weights.partition == ("view",)
    np.testing.assert_allclose(float(psi.full()[0, 0, 0]), float(np.mean(np.stack(views))),
                               rtol=1e-5)


def test_tiff_and_npz_sources(tmp_path):
    views, _, _, _ = _problem(seed=9)
    srcs = []
    for v, arr in enumerate(views):
        if v % 2 == 0:
            p = tmp_path / f"view_{v}.tif"
            write_tiff_stack(str(p), arr)
            srcs.append(str(p))
        else:
            p = tmp_path / f"view_{v}.npz"
            save_stack_npz(str(p), view=arr)
            srcs.append(f"{p}:view")
    mesh = _mesh(2, 4)
    got = make_sharded_stack(mesh, [as_reader(s) for s in srcs], SHAPE).full().numpy()
    np.testing.assert_allclose(got, np.stack(views), rtol=1e-6)
    with pytest.raises(TypeError, match="unsupported view source"):
        as_reader(3.0)


def test_psi0_source_is_read_by_block():
    views, k1, k2, ws = _problem()
    mesh = _mesh(2, 4)
    psi0 = np.random.default_rng(3).gamma(2.0, 10.0, SHAPE).astype(np.float32)
    readers, calls = _recording([as_reader(psi0)])
    psi, _ = load_sharded_workspace(mesh, views, k1, k2, ws, SHAPE, psi0=readers[0])
    np.testing.assert_array_equal(psi.full().numpy(), psi0)
    assert len(calls) == 4  # one read per z slab, shared by the two view rows
