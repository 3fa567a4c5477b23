"""The 90th percentile of every stack's latency in the window, from its
call to its result being ready on the device, in ms, by nearest rank.  A
stack in a batch has its call's latency; a stack that failed counts as
infinite, over every limit."""

import math


def read(r):
    lat = sorted(r["stack_latencies_s"])
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
