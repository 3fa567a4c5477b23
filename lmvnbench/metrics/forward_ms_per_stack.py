"""Device ms per stack of the per-call kernel forwarding: the activity
inside the range the benchmark wraps, from outside, around
``deconv/rl.py``'s ``_forward_spectra``."""

RANGE = "lmvnbench.forward_spectra"


def read(w):
    s = w.inside_s(RANGE)
    if s is None:
        w.notes.append(f"forward_ms_per_stack: no device span {RANGE} in the trace "
                       "(is deconv.rl._forward_spectra still where deconvolve forwards the kernels?)")
        return None
    return 1e3 * s / w.stacks
