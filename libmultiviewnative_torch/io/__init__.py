"""Image stack IO (TIFF, HDF5, NPZ) and iteration checkpointing."""

from .checkpoint import CheckpointManager, deconvolve_checkpointed, deconvolve_resilient
from .stacks import (
    load_stack_npz,
    read_shape_sidecar,
    read_tiff_stack,
    save_stack_npz,
    write_shape_sidecar,
    write_tiff_stack,
)
