"""The port's core modules (shapes, wrap, fft, convolve) against the JAX
package on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import kernels_3d
from libmultiviewnative_tpu.core import shapes as jshapes
from libmultiviewnative_tpu.core.convolve import fft_convolve3d as jax_fft_convolve3d
from libmultiviewnative_tpu.core.fft import forward_kernel_spectrum as jax_fwd
from libmultiviewnative_tpu.core.wrap import (
    crop_at_offsets as jax_crop,
    embed_at_offsets as jax_embed,
    wrap_kernel as jax_wrap_kernel,
)
from libmultiviewnative_tpu.reference.oracle import direct_convolve
from libmultiviewnative_torch.core import shapes
from libmultiviewnative_torch.core.convolve import convolve_spectrum, fft_convolve3d
from libmultiviewnative_torch.core.fft import (
    KernelSpectrumCache,
    forward_kernel_spectrum,
    irfft3,
    rfft3,
)
from libmultiviewnative_torch.core.wrap import crop_at_offsets, embed_at_offsets, wrap_kernel

torch.set_num_threads(1)

_KERNELS = kernels_3d(3)
_KERNELS["oversized_all1"] = np.ones((5, 6, 7), np.float32)
_KERNELS["even_ramp"] = np.arange(4 * 4 * 2, dtype=np.float32).reshape(4, 4, 2)


@pytest.mark.parametrize("name", sorted(_KERNELS))
@pytest.mark.parametrize("extents", [(8, 8, 8), (4, 5, 3)], ids=str)
def test_wrap_kernel_bitwise(name, extents):
    """Integer-valued taps: the aliasing fold of an oversized kernel sums
    exactly, so every case is bitwise."""
    k = _KERNELS[name]
    want = np.asarray(jax_wrap_kernel(jnp.asarray(k), extents))
    got = wrap_kernel(torch.from_numpy(k), extents).numpy()
    np.testing.assert_array_equal(got, want)


def test_embed_and_crop_match_jax():
    img = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    want = np.asarray(jax_embed(jnp.asarray(img), (6, 7, 9), (1, 2, 3)))
    got = embed_at_offsets(torch.from_numpy(img), (6, 7, 9), (1, 2, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        crop_at_offsets(got, (3, 4, 5), (1, 2, 3)).numpy(),
        np.asarray(jax_crop(jnp.asarray(want), (3, 4, 5), (1, 2, 3))),
    )
    with pytest.raises(ValueError, match="exceeds extents"):
        embed_at_offsets(torch.from_numpy(img), (3, 4, 5), (1, 0, 0))


@pytest.mark.parametrize("kshape", [(3, 3, 3), (4, 3, 2), (21, 21, 21)], ids=str)
def test_shape_helpers_match_jax(kshape):
    assert shapes.zero_pad_extents((16, 9, 5), kshape) == jshapes.zero_pad_extents((16, 9, 5), kshape)
    assert shapes.zero_pad_offsets(kshape) == jshapes.zero_pad_offsets(kshape)
    assert shapes.halo_widths(kshape) == jshapes.halo_widths(kshape)
    assert shapes.next_fast_shape(kshape) == jshapes.next_fast_shape(kshape)


def _image(shape, seed=3):
    return np.random.default_rng(seed).gamma(2.0, 5.0, shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["circular", "linear"])
@pytest.mark.parametrize("name", ["horizontal", "asymm_cross", "all1"])
@pytest.mark.parametrize("shape", [(8, 10, 12), (7, 6, 9)], ids=str)
def test_fft_convolve3d_matches_jax(mode, name, shape):
    """rtol 1e-5 of max|out|: two FFT libraries (XLA's and PyTorch's)."""
    img, k = _image(shape), _KERNELS[name]
    want = np.asarray(jax_fft_convolve3d(jnp.asarray(img), jnp.asarray(k), mode=mode))
    got = fft_convolve3d(torch.from_numpy(img), torch.from_numpy(k), mode=mode).numpy()
    assert got.shape == want.shape == img.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_linear_convolve_matches_direct_oracle():
    img, k = _image((6, 7, 9)), _KERNELS["asymm_cross"]
    got = fft_convolve3d(torch.from_numpy(img), torch.from_numpy(k), mode="linear").numpy()
    want = direct_convolve(img, k, boundary="zero")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_odd_x_roundtrip_needs_s():
    x = torch.from_numpy(_image((5, 6, 7)))
    back = irfft3(rfft3(x), x.shape)
    assert back.shape == x.shape
    torch.testing.assert_close(back, x, rtol=1e-5, atol=1e-4)


def test_convolve_spectrum_batch_both_ways():
    """A stack of x against one spectrum, and one x against a stack of
    spectra (the simultaneous view order) give the per-entry results."""
    xs = torch.from_numpy(_image((3, 6, 5, 7)))
    ks = torch.stack(
        [forward_kernel_spectrum(torch.from_numpy(_KERNELS[n]), (6, 5, 7))
         for n in ("horizontal", "vertical", "depth")]
    )
    one = convolve_spectrum(xs, ks[0])
    many = convolve_spectrum(xs[0], ks)
    for i in range(3):
        torch.testing.assert_close(one[i], convolve_spectrum(xs[i], ks[0]))
        torch.testing.assert_close(many[i], convolve_spectrum(xs[0], ks[i]))
    adj = convolve_spectrum(xs, ks[0], conj_k=True)
    torch.testing.assert_close(adj, convolve_spectrum(xs, ks[0].conj().resolve_conj()))


def test_forward_kernel_spectrum_and_cache():
    k = torch.from_numpy(_KERNELS["asymm_cross"])
    want = np.asarray(jax_fwd(jnp.asarray(k.numpy()), (8, 6, 9)))
    cache = KernelSpectrumCache(maxsize=2)
    got = cache.get(k, (8, 6, 9))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert cache.get(k, (8, 6, 9)) is got
    cache.get(k.clone(), (8, 6, 9))
    cache.get(k, (4, 4, 4))
    assert len(cache) == 2  # LRU-bounded
    cache.clear()
    assert len(cache) == 0
