"""The inputs of a cell, made on the device from ``--seed`` and the
configuration's file.

The recipe is the one behind the repository's speed records: Gaussian
kernel1 of 21³ with sigma 2.0 + 0.5·v, kernel2 the flipped kernel1 padded to
25³ (or kernel1 itself under ``adjoint_kernel2``, where the program ignores
it), views drawn from gamma(2, 20), weights 1/V per voxel or per view, and
psi0 the mean of its stack.  The benchmark makes them; the program and the
reference are handed the same tensors, or tensors made again from the same
seed, which are equal.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one random stream of a run: ``seed`` (any whole
    number) and the stream's ``key`` mixed by numpy's SeedSequence."""
    words = [seed % 2**64, *key]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def gaussian(shape, sigma: float, device) -> torch.Tensor:
    """A normalised isotropic Gaussian on ``shape``, centred at ``k // 2``,
    computed in float64 and stored as float32."""
    axes = [torch.arange(s, dtype=torch.float64, device=device) - s // 2 for s in shape]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    k = torch.exp(-(zz * zz + yy * yy + xx * xx) / (2.0 * sigma**2))
    return (k / k.sum()).to(torch.float32)


def pad_centered(kernel: torch.Tensor, shape) -> torch.Tensor:
    """``kernel`` zero-padded to ``shape`` with its centre voxel kept at
    ``shape // 2``."""
    pads = []
    for k, t in zip(reversed(kernel.shape), reversed(tuple(shape))):
        lo = t // 2 - k // 2
        if lo < 0 or t - k - lo < 0:
            raise ValueError(f"kernel {tuple(kernel.shape)} does not fit {tuple(shape)}")
        pads += [lo, t - k - lo]
    return torch.nn.functional.pad(kernel, pads)


def kernels(cfg: dict, device):
    """(kernel1, kernel2) stacks of the configuration, (V, kz, ky, kx)."""
    V = cfg["views"]
    spec = cfg["kernel1"]
    k1 = torch.stack([gaussian(spec["shape"], spec["sigma0"] + spec["sigma_step"] * v, device)
                      for v in range(V)])
    if cfg["adjoint_kernel2"]:
        return k1, k1
    k2 = torch.stack([pad_centered(torch.flip(k, (0, 1, 2)), cfg["kernel2_shape"]) for k in k1])
    return k1, k2


def weights(cfg: dict, device) -> torch.Tensor:
    """1/V for each view: (V, Z, Y, X) ``per_voxel``, (V,) ``per_view``."""
    V = cfg["views"]
    shape = {"per_voxel": (V, *cfg["shape"]), "per_view": (V,)}[cfg["weights"]]
    return torch.full(shape, 1.0 / V, dtype=torch.float32, device=device)


def stack_views(cfg: dict, seed: int, t: int, device) -> torch.Tensor:
    """Time point ``t``'s views, (V, Z, Y, X) float32, gamma-distributed
    with an integer shape k as the scaled sum of k exponential draws, in one
    call on the device."""
    gamma = cfg["view_gamma"]
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1, t))
    draws = torch.empty((gamma["shape"], cfg["views"], *cfg["shape"]), dtype=torch.float32,
                        device=device)
    draws.exponential_(generator=g)
    views = draws.sum(0)
    del draws
    return views.mul_(gamma["scale"])


def start_value(views: torch.Tensor) -> torch.Tensor:
    """psi0's value for a stack: the mean of its views, a 0-dim tensor."""
    return views.mean()
