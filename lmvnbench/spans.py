"""The device's idle time inside the program's own spans, split by layer.

The port records host-only spans on the profiler's clock
(``libmultiviewnative_torch.utils.trace.span``): ``lmvn.call`` round
``deconvolve_auto``, ``lmvn.rung.<rung>`` round the rung it runs,
``lmvn.deconvolve`` round the driver, ``lmvn.forward`` round the kernel
forwarding and ``lmvn.engine.<op>`` round each engine call.  They are
events of :attr:`..profiling.Window.host`; the device's activity is
:attr:`..profiling.Window.kernels`.

Device idle time is host time not covered by the union of the device's
activity.  Each idle microsecond inside an ``lmvn.call`` goes to the first
layer whose spans hold it: the forwarding, then the engine, then the driver
(``lmvn.deconvolve`` or any rung), and what is left to the ladder.
"""

from __future__ import annotations

from typing import Optional

from lmvnbench.profiling import REQUEST_RANGE

CALL = "lmvn.call"
# in the order an idle microsecond is given to them
LAYERS = ("forward", "engine", "driver", "ladder")


def layer_of(name: str) -> Optional[str]:
    """The layer a span of the program marks (None for other events and for
    ``lmvn.call``, which holds them all)."""
    if name == "lmvn.forward":
        return "forward"
    if name.startswith("lmvn.engine."):
        return "engine"
    if name == "lmvn.deconvolve" or name.startswith("lmvn.rung."):
        return "driver"
    return None


def merged(intervals) -> list:
    """The union of [start, end) intervals, as sorted disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def minus(a: list, b: list) -> list:
    """``a`` less ``b``, both as :func:`merged` gives them."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def length(a: list) -> float:
    return sum(e - s for s, e in a)


def idle_split(w) -> Optional[dict]:
    """Seconds of device idle in the window: by layer inside ``lmvn.call``
    (:data:`LAYERS`), ``outside_call`` (inside the benchmark's requests but
    outside every call) and ``requests`` (all of it inside the requests);
    None when the window holds no ``lmvn.call``."""
    spans = {layer: [] for layer in LAYERS}
    calls, requests = [], []
    for s, e, name in w.host:
        if name == CALL:
            calls.append((s, e))
        elif name == REQUEST_RANGE:
            requests.append((s, e))
        else:
            layer = layer_of(name)
            if layer is not None:
                spans[layer].append((s, e))
    if not calls:
        return None
    busy = merged((s, e) for _, s, e in w.kernels)
    calls = merged(calls)
    left = minus(calls, busy)
    out = {}
    for layer in LAYERS[:-1]:
        rest = minus(left, merged(spans[layer]))
        out[layer] = (length(left) - length(rest)) / 1e6
        left = rest
    out["ladder"] = length(left) / 1e6
    idle_in_requests = minus(merged(requests), busy)
    out["outside_call"] = length(minus(idle_in_requests, calls)) / 1e6
    out["requests"] = length(idle_in_requests) / 1e6
    return out


def idle_ms_per_stack(w, layer: str, metric: str) -> Optional[float]:
    """A layer's device idle ms per stack (:func:`idle_split`); None, with
    a note, when the program recorded no ``lmvn.call`` span."""
    split = idle_split(w)
    if split is None:
        w.notes.append(f"{metric}: no {CALL} span in the trace (the program records none)")
        return None
    return 1e3 * split[layer] / w.stacks
