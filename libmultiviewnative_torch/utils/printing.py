"""Stack pretty-printing.

Counterpart of ``libmultiviewnative_tpu/utils/printing.py``, after the
reference's debug printers (``print_stack``,
``inc/image_stack_utils.h:97-138``, and ``operator<<``,
``src/image_stack_utils.cpp:27-67``): a z-plane-by-plane matrix dump for
eyeballing small volumes.  A tensor is read back to the host first.
"""

from __future__ import annotations

import io

import numpy as np
import torch


def format_stack(stack, max_planes: int = 8, width: int = 8, prec: int = 3) -> str:
    a = stack.detach().cpu().numpy() if isinstance(stack, torch.Tensor) else np.asarray(stack)
    if a.ndim != 3:
        return np.array2string(a, precision=prec)
    out = io.StringIO()
    out.write(f"image_stack {a.shape[0]}x{a.shape[1]}x{a.shape[2]} (z, y, x)\n")
    for z in range(min(a.shape[0], max_planes)):
        out.write(f"-- z = {z} --\n")
        for y in range(a.shape[1]):
            out.write(
                " ".join(f"{v:{width}.{prec}f}" for v in a[z, y]) + "\n"
            )
    if a.shape[0] > max_planes:
        out.write(f"... ({a.shape[0] - max_planes} more planes)\n")
    return out.getvalue()


def print_stack(stack, **kw) -> None:
    print(format_stack(stack, **kw))
