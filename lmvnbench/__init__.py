"""The benchmark of ``libmultiviewnative_torch`` on an NVIDIA GPU.

It lives outside the package it measures, so that a change to the program
cannot change its yardstick: the traffic generator, the plain reference,
the least-work count and the reduction of traces to metrics are here.
The only program it imports is ``libmultiviewnative_torch``.
"""
