"""The port's stack I/O and checkpointing (``io/``) against the JAX
package's: stacks written by one package and read by the other, bitwise;
the checkpoint manager; a checkpointed and resumed run against the
uninterrupted one (bitwise: each chunk starts a view step from psi alone)
and against JAX's (1e-4 of max|psi|, test_torch_rl.py's RTOL); and the
resilient driver through injected failures (tests/test_resilience.py's
cases).
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_tpu.deconv.workspace import Workspace as JaxWs, initial_psi as jax_psi0
from libmultiviewnative_tpu.io import checkpoint as jckpt, stacks as jstacks
from libmultiviewnative_tpu.utils.synthetic import multiview_data as jax_multiview_data
from libmultiviewnative_torch.deconv.rl import deconvolve
from libmultiviewnative_torch.deconv.workspace import Workspace, initial_psi
from libmultiviewnative_torch.io import checkpoint as ckpt, stacks
from libmultiviewnative_torch.io.checkpoint import (
    CheckpointManager,
    deconvolve_checkpointed,
    deconvolve_resilient,
)
from libmultiviewnative_torch.utils.synthetic import multiview_data

torch.set_num_threads(1)

RTOL = 1e-4


def _stack(seed=4, shape=(6, 10, 12)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _roundtrip(fmt, writer, reader, path):
    a = _stack()
    if fmt == "tif":
        writer.write_tiff_stack(path, a)
        return a, reader.read_tiff_stack(path)
    if fmt == "npz":
        writer.save_stack_npz(path, psi=a, other=a * 2)
        back = reader.load_stack_npz(path)
        np.testing.assert_array_equal(back["other"], a * 2)
        return a, back["psi"]
    if fmt == "h5":
        writer.save_stack_h5(path, chunks_z=4, vol=a)
        return a, reader.load_stack_h5(path, "vol")
    writer.write_shape_sidecar(path, a.shape)
    return np.asarray(a.shape), np.asarray(reader.read_shape_sidecar(path))


@pytest.mark.parametrize("fmt", ["tif", "npz", "h5", "shape"])
@pytest.mark.parametrize("direction", ["torch-to-jax", "jax-to-torch"])
def test_stacks_cross_read_bitwise(tmp_path, fmt, direction):
    writer, reader = (stacks, jstacks) if direction == "torch-to-jax" else (jstacks, stacks)
    want, got = _roundtrip(fmt, writer, reader, str(tmp_path / f"s.{fmt}"))
    np.testing.assert_array_equal(got, want)


def test_tiff_rejects_all_nan(tmp_path):
    p = str(tmp_path / "nan.tif")
    stacks.write_tiff_stack(p, np.full((2, 4, 4), np.nan, np.float32))
    with pytest.raises(ValueError, match="entirely NaN"):
        stacks.read_tiff_stack(p)


def test_open_stack_h5_chunked_reads(tmp_path):
    a = _stack(1, (20, 6, 6))
    p = str(tmp_path / "c.h5")
    stacks.save_stack_h5(p, chunks_z=4, vol=a)
    f, dset = stacks.open_stack_h5(p, "vol")
    try:
        np.testing.assert_array_equal(np.asarray(dset[4:8]), a[4:8])
    finally:
        f.close()


@pytest.mark.parametrize("fmt", ["npz", "tif"])
def test_checkpoint_manager_roundtrip_and_latest(tmp_path, fmt):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), fmt=fmt)
    assert mgr.latest() is None
    a = np.ones((3, 4, 5), np.float32)
    mgr.save(0, a)
    mgr.save(3, a * 3)
    it, psi = mgr.latest()
    assert it == 3
    np.testing.assert_array_equal(psi, a * 3)
    # the JAX manager reads the port's snapshots
    it, psi = jckpt.CheckpointManager(str(tmp_path / "ckpt"), fmt=fmt).latest()
    assert it == 3
    np.testing.assert_array_equal(psi, a * 3)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "x"), fmt="png")


@pytest.fixture(scope="module")
def problem():
    # 16³, 5³ kernels: every axis a multiple of 8 for the fused engine
    views = multiview_data(2, (16, 16, 16), (5, 5, 5), (5, 5, 5), kernel="gaussian", seed=6)
    data = Workspace.from_views(views, device="cpu").data
    return initial_psi(data, "average").numpy(), data


@pytest.mark.parametrize("algorithm", ["fft", "fused"])
def test_checkpointed_resume_equals_uninterrupted(tmp_path, problem, algorithm):
    psi0, data = problem
    kw = dict(lam=0.006, algorithm=algorithm)
    whole = deconvolve(torch.from_numpy(psi0), data, 4, **kw)
    mgr = CheckpointManager(str(tmp_path / "a"))
    out_a = deconvolve_checkpointed(psi0, data, 4, mgr, checkpoint_every=2, **kw)
    assert out_a.device == data.device
    np.testing.assert_array_equal(out_a.numpy(), whole.numpy())
    # interrupted after 2, then resumed from psi_1
    mgr_b = CheckpointManager(str(tmp_path / "b"))
    deconvolve_checkpointed(psi0, data, 2, mgr_b, checkpoint_every=1, **kw)
    out_b = deconvolve_checkpointed(psi0, data, 4, mgr_b, checkpoint_every=1, **kw)
    np.testing.assert_array_equal(out_b.numpy(), whole.numpy())
    it, snap = mgr_b.latest()
    assert it == 3
    np.testing.assert_array_equal(snap, out_b.numpy())


def test_checkpointed_matches_jax(tmp_path):
    ws = JaxWs.from_views(jax_multiview_data(2, (12, 12, 12), kernel="gaussian", seed=6))
    psi0 = np.asarray(jax_psi0(ws.data, "average"))
    want = jckpt.deconvolve_checkpointed(psi0, ws.data, 3, jckpt.CheckpointManager(
        str(tmp_path / "jax")), lam=0.006, checkpoint_every=2, algorithm="fft")
    data = Workspace.from_views(multiview_data(2, (12, 12, 12), kernel="gaussian", seed=6),
                                device="cpu").data
    got = deconvolve_checkpointed(psi0, data, 3, CheckpointManager(str(tmp_path / "torch")),
                                  lam=0.006, checkpoint_every=2, algorithm="fft")
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) <= RTOL


def test_resilient_recovers_from_midrun_crash(tmp_path, problem, monkeypatch):
    psi0, data = problem
    real = ckpt.deconvolve_checkpointed
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            # a crash after 2 of 4 iterations: run the first chunk, then die
            real(args[0], args[1], 2, args[3], **kw)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*args, **kw)

    monkeypatch.setattr(ckpt, "deconvolve_checkpointed", flaky)
    failures = []
    out = deconvolve_resilient(psi0, data, 4, CheckpointManager(str(tmp_path / "r")),
                               checkpoint_every=1, on_failure=lambda e, i: failures.append(i))
    assert calls["n"] == 2 and failures == [1]  # one crash, one successful resume
    want = real(psi0, data, 4, CheckpointManager(str(tmp_path / "clean")), checkpoint_every=1)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_resilient_gives_up_after_max_retries(tmp_path, problem, monkeypatch):
    psi0, data = problem

    def always_dead(*a, **k):
        raise RuntimeError("dead device")

    monkeypatch.setattr(ckpt, "deconvolve_checkpointed", always_dead)
    failures = []
    with pytest.raises(RuntimeError, match="dead device"):
        deconvolve_resilient(psi0, data, 4, CheckpointManager(str(tmp_path / "g")),
                             max_retries=2, on_failure=lambda e, i: failures.append(i))
    assert failures == [1, 2, 3]
