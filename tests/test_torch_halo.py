"""The port's z-block convolves (parallel/halo.py) against the JAX package's
on a mesh of 8 cells: JAX's on its 8 virtual CPU devices through
``shard_map``, the port's on 8 CPU cells of one process.

The ring halo exchange makes overlap-save exact for the global circular
boundary, so every engine is also held against the single-device circular
convolve of the whole volume.  Tolerance 1e-4 (rtol and atol), as
tests/test_sharded.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from libmultiviewnative_tpu.core import dft as jdft
from libmultiviewnative_tpu.core.convolve import fft_convolve3d as jax_fft_convolve3d
from libmultiviewnative_tpu.parallel import halo as jhalo
from libmultiviewnative_torch.core.shapes import halo_widths
from libmultiviewnative_torch.ops.fused import fused_convolve_transposed, kernel_spectrum_fused
from libmultiviewnative_torch.parallel import halo
from libmultiviewnative_torch.parallel.sharded import MeshTensor, make_mesh, shard_tensor

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

TOL = 1e-4


def _problem(kshape, shape=(16, 8, 8), seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=kshape).astype(np.float32))


def _jax_zblock(x, k, engine):
    (lo, _, _), (hi, _, _) = halo_widths(k.shape)
    mesh = JaxMesh(np.asarray(jax.devices()[:8]), ("z",))
    if engine == "dft":
        # JAX's dft plans are lru-cached; built first inside an eager
        # shard_map they hold its tracers and break later callers (ROADMAP
        # R7), so the spectrum and the extent's plans are built out here
        local = (x.shape[0] // 8,) + x.shape[1:]
        ks = jhalo.zblock_kernel_spectrum_split(jnp.asarray(k), local)
        jdft.dft_convolve_spectrum(jnp.zeros((local[0] + lo + hi,) + x.shape[1:]), *ks)

    def f(block):
        if engine == "dft":
            return jhalo.convolve_zblock_dft(block, ks, lo, hi, "z")
        kh = jhalo.zblock_kernel_spectrum(jnp.asarray(k), block.shape)
        return jhalo.convolve_zblock(block, kh, lo, hi, "z")

    out = jax.shard_map(f, mesh=mesh, in_specs=P("z", None, None), out_specs=P("z", None, None))
    return np.asarray(out(jnp.asarray(x)))


def _port_zblock(x, k, engine, zp=8):
    (lo, _, _), (hi, _, _) = halo_widths(k.shape)
    mesh = make_mesh(1, zp, devices=["cpu"] * zp)
    xt = torch.from_numpy(x)
    local = (x.shape[0] // zp,) + x.shape[1:]
    kt = torch.from_numpy(k)
    if engine == "fused":
        blocks = shard_tensor(xt.transpose(1, 2).contiguous(), mesh, ("z",)).blocks
        ks = halo.zblock_kernel_spectrum_fused(kt, local)
        out = halo.convolve_zblock_fused(blocks, ks, lo, hi, mesh)
        got = MeshTensor(mesh, (x.shape[0], x.shape[2], x.shape[1]), ("z",), out).full()
        return got.transpose(1, 2).numpy()
    blocks = shard_tensor(xt, mesh, ("z",)).blocks
    if engine == "dft":
        out = halo.convolve_zblock_dft(blocks, halo.zblock_kernel_spectrum_split(kt, local), lo, hi,
                                       mesh)
    else:
        out = halo.convolve_zblock(blocks, halo.zblock_kernel_spectrum(kt, local), lo, hi, mesh)
    return MeshTensor(mesh, x.shape, ("z",), out).full().numpy()


@pytest.mark.parametrize("engine", ["fft", "dft"])
@pytest.mark.parametrize("kshape", [(3, 3, 3), (5, 4, 3)])
def test_zblock_convolve_matches_jax(kshape, engine):
    x, k = _problem(kshape)
    want = _jax_zblock(x, k, engine)
    got = _port_zblock(x, k, engine)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    whole = np.asarray(jax_fft_convolve3d(x, k, mode="circular"))
    np.testing.assert_allclose(got, whole, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("zp", [2, 4, 8])
@pytest.mark.parametrize("kshape", [(3, 3, 3), (5, 4, 3)])
def test_zblock_fused_matches_the_whole_volume(kshape, zp):
    """The fused z-block convolve (K4, K6, K7's plain passes here) at the
    8-aligned halo-extended extent against the fused convolve of the whole
    volume and JAX's circular convolve."""
    x, k = _problem(kshape)
    got = _port_zblock(x, k, "fused", zp)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    whole = fused_convolve_transposed(xt, *kernel_spectrum_fused(torch.from_numpy(k), x.shape))
    np.testing.assert_allclose(got, whole.transpose(1, 2).numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_fft_convolve3d(x, k, mode="circular")),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bz, lo, hi", [(2, 1, 1), (64, 10, 10), (64, 12, 12), (256, 12, 12),
                                        (5, 2, 1)])
def test_zblock_fused_extent_matches_jax(bz, lo, hi):
    assert halo.zblock_fused_extent(bz, lo, hi) == jhalo.zblock_fused_extent(bz, lo, hi)
    assert halo.zblock_fused_extent(bz, lo, hi) % 8 == 0


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_ring_perms_match_jax(n):
    assert halo._ring_perms(n) == jhalo._ring_perms(n)


def test_halo_exchange_wraps_the_ring():
    """Block z's lower halo is block z-1's top planes and its upper halo
    block z+1's bottom planes, around the ring; the old blocks are left as
    they were (cells on one device read no half-written neighbour)."""
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    x = torch.arange(8 * 2 * 2, dtype=torch.float32).reshape(8, 2, 2)
    blocks = shard_tensor(x, mesh, ("z",)).blocks
    before = {c: b.clone() for c, b in blocks.items()}
    ext = halo.halo_exchange_z(blocks, 1, 2, mesh)
    idx = np.arange(8)
    for (v, z), e in ext.items():
        planes = idx[np.arange(2 * z - 1, 2 * z + 4) % 8]
        torch.testing.assert_close(e, x[planes], rtol=0, atol=0)
        torch.testing.assert_close(blocks[(v, z)], before[(v, z)], rtol=0, atol=0)
