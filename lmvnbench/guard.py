"""The import guard: the port runs without JAX.

A module counts by its whole top-level name, the part before the first
dot, so the port (``libmultiviewnative_torch``) never matches the JAX
package (``libmultiviewnative_tpu``) whose name it begins with.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "libmultiviewnative_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
