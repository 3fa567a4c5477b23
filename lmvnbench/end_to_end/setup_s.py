"""Seconds from the process's start to the first timed request: imports,
loading (or building) the kernels, making the inputs, warming up."""


def read(r):
    return r["setup_s"]
