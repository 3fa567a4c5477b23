"""Benchmark logging row: the schema of the reference's ``bench/logging.hpp:9-60``.

Counterpart of ``libmultiviewnative_tpu/utils/logging.py``.  One
whitespace-separated row per measurement:

    n_devices dev_type dev_name n_repeats total_time_ms dims_x dims_y dims_z \
        type_width_byte comment

so sweep tooling written for the reference keeps working against this build.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass
class BenchRow:
    n_devices: int
    dev_type: str
    dev_name: str
    n_repeats: int
    total_time_ms: float
    dims: Sequence[int]  # (x, y, z) order, as the reference logs them
    type_width_byte: int = 4
    comment: str = ""

    def line(self) -> str:
        dims = " ".join(str(int(d)) for d in self.dims)
        comment = self.comment.replace(" ", "_") or "-"
        return (
            f"{self.n_devices} {self.dev_type} {self.dev_name.replace(' ', '_')} "
            f"{self.n_repeats} {self.total_time_ms:.6f} {dims} "
            f"{self.type_width_byte} {comment}"
        )


def current_device_row(
    n_repeats: int, total_time_ms: float, dims: Sequence[int], comment: str = ""
) -> BenchRow:
    """A row for the card this process runs on (card 0); raises where there
    is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("current_device_row: no CUDA device to name")
    return BenchRow(
        n_devices=torch.cuda.device_count(),
        dev_type="gpu",
        dev_name=torch.cuda.get_device_name(0),
        n_repeats=n_repeats,
        total_time_ms=total_time_ms,
        dims=dims,
        comment=comment,
    )
