"""One less the device's busy time (the union of its activity intervals)
over the traced window's wall time."""


def read(w):
    return 1.0 - w.busy_s / w.wall_s
