"""The device memory the program held at its peak in the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's start),
in GiB: what decides whether a user's stack stays on the in-core rung."""


def read(r):
    return r["peak_bytes"] / 2**30
