"""Device idle ms per stack while the host is in an engine call
(``lmvn.engine.*``: the fused passes, ``convolve_spectrum``, K1 and K2)
outside the forwarding: the launch path while the card has nothing queued
(:mod:`lmvnbench.spans`)."""

from lmvnbench.spans import idle_ms_per_stack


def read(w):
    return idle_ms_per_stack(w, "engine", "engine_idle_ms_per_stack")
