"""Multi-process initialization and process-level helpers.

Counterpart of ``libmultiviewnative_tpu/parallel/distributed.py``.  The
reference is single-process (SURVEY.md §2.5).  Here every process runs the
same program: :func:`initialize_multihost` joins them through
``torch.distributed`` (NCCL between CUDA cells, gloo between CPU cells),
and the same ('view', 'z') mesh of :mod:`.sharded` spans them.  A process
drives its own cells; the collectives between processes go through the
default process group and the groups :func:`.sharded.make_mesh` creates.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group.  A no-op for a single process (no arguments
    and no ``MASTER_ADDR``/``WORLD_SIZE`` in the environment), so the same
    script runs everywhere.

    ``coordinator_address`` is ``host:port`` of rank 0; ``num_processes``
    and ``process_id`` fall back to ``WORLD_SIZE`` and ``RANK``, the address
    to ``MASTER_ADDR``/``MASTER_PORT``.  ``backend``: ``"nccl"`` where the
    cells are CUDA devices, ``"gloo"`` where they are CPUs; by default NCCL
    when a card is visible, else gloo."""
    env = os.environ
    if num_processes is None and coordinator_address is None:
        if "MASTER_ADDR" not in env and "WORLD_SIZE" not in env:
            return
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT', '29500')}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )


def process_index() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes, 1 outside a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_devices() -> list:
    """This process's devices: the visible CUDA devices, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def describe_topology() -> dict:
    """A structured record of the processes and devices (the reference's
    device-query printfs, ``inc/cuda_helpers.cuh:84-136``, for a fleet)."""
    devs = local_devices()
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": [str(d) for d in devs],
        "global_device_count": len(devs) * process_count(),
        "platform": devs[0].type,
    }


def host_local_views(num_views: int) -> range:
    """The contiguous block of view indices this process loads."""
    per = -(-num_views // process_count())
    lo = process_index() * per
    return range(lo, min(lo + per, num_views))
