"""Device idle ms per stack while the host is in the driver (``deconv/rl.py``
``deconvolve`` or a rung of the ladder) outside the forwarding and the
engine calls: the transposes, the weights read back, the view loop
(:mod:`lmvnbench.spans`)."""

from lmvnbench.spans import idle_ms_per_stack


def read(w):
    return idle_ms_per_stack(w, "driver", "driver_idle_ms_per_stack")
