"""The whole RL step's share of the chip's peak, in %: the least time of
the window's work (``roofline.py``: the larger of its bytes over HBM
bandwidth and its FFT operations over the fp32 rate) over the window's wall
time.  It bounds every kernel's share: a change that takes a kernel off
the path still answers to it."""

from lmvnbench.roofline import share


def read(w):
    return 100.0 * share(w.least_s, w.wall_s)
