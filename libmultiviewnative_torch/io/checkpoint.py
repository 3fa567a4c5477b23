"""Per-iteration psi checkpointing and resume.

Counterpart of ``libmultiviewnative_tpu/io/checkpoint.py``.  The reference
has no in-library checkpointing; its ecosystem convention is
iteration-indexed ``psi_i.tif`` snapshots written externally
(``tests/tiff_fixtures.hpp:453-462``): any iteration's output is a valid
restart point, because the RL update is a pure function of psi.  Here that
convention is formalized: a :class:`CheckpointManager` that writes psi
snapshots (TIFF for Fiji interop, NPZ for fidelity) and a
:func:`deconvolve_checkpointed` driver that resumes from the newest one.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..deconv.rl import deconvolve
from ..deconv.workspace import MultiViewData
from .stacks import load_stack_npz, read_tiff_stack, save_stack_npz, write_tiff_stack

_PSI_RE = re.compile(r"psi_(\d+)\.(npz|tif|tiff)$")


class CheckpointManager:
    """Writes/loads iteration-indexed psi snapshots in a directory.

    File naming follows the golden-data convention psi_<i>.<ext>
    (``tests/tiff_fixtures.hpp:453-462``): psi_i is the state AFTER
    iteration i (0-based)."""

    def __init__(self, directory: str, fmt: str = "npz") -> None:
        if fmt not in ("npz", "tif"):
            raise ValueError(f"unknown checkpoint format {fmt!r}")
        self.directory = directory
        self.fmt = fmt
        os.makedirs(directory, exist_ok=True)

    def path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"psi_{iteration}.{self.fmt}")

    def save(self, iteration: int, psi: np.ndarray) -> str:
        p = self.path(iteration)
        if self.fmt == "npz":
            save_stack_npz(p, psi=np.asarray(psi, np.float32))
        else:
            write_tiff_stack(p, psi)
        return p

    def load(self, iteration: int) -> np.ndarray:
        p = self.path(iteration)
        if self.fmt == "npz":
            return load_stack_npz(p)["psi"]
        return read_tiff_stack(p)

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        """Newest (iteration, psi) snapshot, or None."""
        best = -1
        best_path = None
        for p in glob.glob(os.path.join(self.directory, "psi_*.*")):
            m = _PSI_RE.search(os.path.basename(p))
            if m and int(m.group(1)) > best:
                best, best_path = int(m.group(1)), p
        if best_path is None:
            return None
        return best, self.load(best)


def deconvolve_resilient(
    psi,
    data: MultiViewData,
    num_iterations: int,
    manager: CheckpointManager,
    max_retries: int = 3,
    on_failure=None,
    **kw,
) -> torch.Tensor:
    """Checkpointed deconvolve that survives runtime failures.

    The failure-recovery tier the reference lacks (its only resilience is
    NaN clamping).  On an exception the CUDA caching allocator's free blocks
    are released (``torch.cuda.empty_cache()``, the counterpart of JAX's
    ``clear_backends``) and the run resumes from the newest psi_i snapshot;
    after ``max_retries`` failed resumes the last exception is raised.
    ``on_failure(exc, attempt)`` is an optional observer hook.

    What this recovers from is an error that leaves the process usable, such
    as an out-of-memory error or a failure in the host code.  A sticky CUDA
    error (an illegal address, a device-side assert) poisons the process's
    CUDA context and cannot be cleared in process: every resume then fails
    again, and the call raises after ``max_retries``.  Such a run resumes
    from its snapshots in a new process.
    """
    attempt = 0
    while True:
        try:
            return deconvolve_checkpointed(
                psi, data, num_iterations, manager, resume=True, **kw
            )
        except Exception as exc:  # any runtime failure: retry from the snapshot
            attempt += 1
            if on_failure is not None:
                on_failure(exc, attempt)
            if attempt > max_retries:
                raise
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.empty_cache()


def deconvolve_checkpointed(
    psi,
    data: MultiViewData,
    num_iterations: int,
    manager: CheckpointManager,
    lam: float = 0.0,
    min_value: float = 1e-4,
    checkpoint_every: int = 1,
    resume: bool = True,
    **kw,
) -> torch.Tensor:
    """RL :func:`..deconv.rl.deconvolve` with psi snapshots every
    ``checkpoint_every`` iterations, resuming from the newest snapshot.

    Iterations run in chunks of ``checkpoint_every``; psi stays on the
    data's device between chunks and each snapshot is read back to the host.
    ``psi`` is an array or a tensor; ``**kw`` goes to ``deconvolve``
    (``algorithm``, ``view_order``, ...).  Returns psi on the data's device.
    A chunked run equals the uninterrupted one: each call starts a view step
    from psi alone."""
    start = 0
    if resume:
        latest = manager.latest()
        if latest is not None:
            start, psi = latest
            start += 1  # psi_i is the state AFTER iteration i
    if not isinstance(psi, torch.Tensor):
        psi = torch.from_numpy(np.require(psi, np.float32, ["C", "W"]))
    psi = psi.to(device=data.device, dtype=torch.float32)
    it = start
    while it < num_iterations:
        chunk = min(checkpoint_every, num_iterations - it)
        psi = deconvolve(psi, data, chunk, lam=lam, min_value=min_value, **kw)
        it += chunk
        manager.save(it - 1, psi.cpu().numpy())
    return psi
