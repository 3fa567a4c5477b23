"""Device idle ms per stack while the host is in ``deconvolve_auto`` but in
none of its rungs (the ladder, ``deconv/dispatch.py``): the estimate, the
card's capacity query (``cudaMemGetInfo``), the policy calls, before and
after the rung (:mod:`lmvnbench.spans`)."""

from lmvnbench.spans import idle_ms_per_stack


def read(w):
    return idle_ms_per_stack(w, "ladder", "ladder_idle_ms_per_stack")
