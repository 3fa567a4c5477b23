"""The engine's kernels' share of their roofline, in %: the least time of
the window's work over the device's busy time in the window, whichever
engine ran."""

from lmvnbench.roofline import share


def read(w):
    s = share(w.least_s, w.busy_s)
    if s is None:
        w.notes.append("engine_roofline: no device activity in the window")
        return None
    return 100.0 * s
