"""Host-side references (numpy only): the brute-force convolution oracle
and the acceptance tests' error norms (:mod:`.oracle`), and the float64
mirror of the RL pipeline (:mod:`.numpy_ref`)."""

from .numpy_ref import np_convolve_spectrum, np_deconvolve, np_rl_view_step, np_wrap_kernel
from .oracle import (
    direct_convolve,
    l1norm,
    l2norm,
    l2norm_within_limits,
    rms,
    rms_within_limits,
)
