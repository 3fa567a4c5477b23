"""The one traffic generator: a closed loop of one client over a pool of
time points made on the device.

A traffic file (``traffic/<name>.json``) holds its parameters:

* ``driver``: ``closed_loop``, the only driver: request k is sent when
  request k - 1 has completed and its result is ready on the device;
* ``batch``: time points per request, one batched call (1: a single stack);
* ``pool``: requests' worth of distinct inputs made in set-up; request k
  takes pool entry k mod pool, and entry p holds time points
  p·batch … p·batch + batch - 1, each a stack of V views from the seed;
* ``warmup_requests``: requests run in set-up, before the window;
* ``check_requests``: requests whose results are kept, drawn from the seed
  over the whole window, and compared with the reference after it;
* ``traced_requests``: requests a ``--trace 1`` run profiles.

Kernels and weights are shared by the whole time-lapse; psi0 is made anew
for each request, filled with the mean of its stack.
"""

from __future__ import annotations

import random

import torch

from . import inputs

DRIVERS = ("closed_loop",)


class ClosedLoop:
    """The inputs of every request of a cell, on ``device``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if traffic["driver"] not in DRIVERS:
            raise ValueError(f"unknown traffic driver {traffic['driver']!r}: {DRIVERS}")
        self.cfg, self.seed, self.device = cfg, seed, device
        self.batch = int(traffic["batch"])
        self.pool = int(traffic["pool"])
        shape = tuple(cfg["shape"])
        self.psi_shape = shape if self.batch == 1 else (self.batch, *shape)
        self.kernel1, self.kernel2 = inputs.kernels(cfg, device)
        self.weights = inputs.weights(cfg, device)
        self.entries = [self._entry(p) for p in range(self.pool)]

    def time_points(self, k: int) -> list:
        """The time points of request ``k``."""
        p = k % self.pool
        return [p * self.batch + b for b in range(self.batch)]

    def _entry(self, p: int):
        stacks = [inputs.stack_views(self.cfg, self.seed, t, self.device)
                  for t in self.time_points(p)]
        means = torch.stack([inputs.start_value(s) for s in stacks])
        if self.batch == 1:
            return stacks[0], means[0]
        views = torch.stack(stacks, dim=1)  # (V, B, Z, Y, X)
        return views, means

    def request(self, k: int):
        """(psi0, data) of request ``k``; psi0 is a new tensor."""
        from libmultiviewnative_torch.deconv.workspace import MultiViewData

        views, means = self.entries[k % self.pool]
        psi0 = torch.empty(self.psi_shape, dtype=torch.float32, device=self.device)
        psi0.copy_(means.reshape(means.shape + (1, 1, 1)).expand(self.psi_shape))
        return psi0, MultiViewData(views, self.kernel1, self.kernel2, self.weights)

    def release(self) -> None:
        """Drop the pool, the kernels and the weights."""
        self.entries = []
        self.kernel1 = self.kernel2 = self.weights = None


class Sample:
    """A uniform sample of ``size`` results over all requests of a window,
    drawn from the seed as they complete (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(inputs.stream_seed(seed, 2))
        self.kept = {}
        self.seen = 0

    def offer(self, k: int, result) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = result
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[k] = result
