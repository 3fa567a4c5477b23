"""Device activity events (kernels, copies, fills) in the traced window
per stack: the launches of deconv/rl.py's loop, a count that repeats exactly."""


def read(w):
    return len(w.kernels) / w.stacks
