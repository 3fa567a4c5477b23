"""Device idle ms per stack while the host is in the per-call kernel
forwarding (``deconv/rl.py`` ``_forward_spectra``, span ``lmvn.forward``):
its host work between launches (:mod:`lmvnbench.spans`)."""

from lmvnbench.spans import idle_ms_per_stack


def read(w):
    return idle_ms_per_stack(w, "forward", "forward_idle_ms_per_stack")
