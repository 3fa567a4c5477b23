"""libmultiviewnative_torch — multi-view Richardson-Lucy deconvolution in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``libmultiviewnative_tpu`` (JAX), which stays the reference;
this package mirrors its layout and its public names.  It imports torch and
numpy, never jax.  Tensors on the CPU run the plain PyTorch versions of the
kernels; tensors on a CUDA device run the kernels of ``ops/csrc/``, built
with nvcc at first use.

Ported so far: ``deconvolve`` in both view orders, with prepared spectra and
convergence history, on four engines: ``"fft"`` (cuFFT and the elementwise
kernels K1-K3), ``"fused"`` (the fused RL step at fp32, kernels K4-K10:
the five-pass chain, the carried four-pass chain with ``LMVN_FUSED_CARRY=1``
and the dense spectrum forwarding), ``"dft"`` (matrix-product DFTs,
:mod:`.core.dft`) and ``"direct"`` (spatial convolves); ``"auto"`` picks
one by shape and device (:func:`.deconv.rl.resolve_algorithm`).  The
dispatch ladder, :func:`deconvolve_auto` (in-core, the z-only and the
view-sharded mesh rungs, the interleaved rung and the streamed rung), and
the models :class:`RichardsonLucy` and :class:`WienerFilter` are the entry
points a user calls; :mod:`.parallel` lays a ('view', 'z') mesh of devices
(one process or several, through ``torch.distributed``) under the same
view step.  Around them: the flat numpy API of the reference's C ABI
(:mod:`.api`), that C ABI itself as a shared library (``native/``, through
:mod:`.native_entry`; :mod:`.native_client` loads it), the command-line tool
(:mod:`.cli`), stack I/O and checkpoint/resume (:mod:`.io`), and the
utilities of ``utils/`` (validation, PSF compounds, tracing, bench rows).
"""

from .core.shapes import (
    as_shape,
    halo_widths,
    kernel_center,
    next_fast_shape,
    zero_pad_extents,
    zero_pad_offsets,
)
from .core.wrap import crop_at_offsets, embed_at_offsets
from .core.convolve import convolve3d, convolve_spectrum, direct_convolve3d, fft_convolve3d
from .core.dft import (
    dft3,
    dft_convolve_spectrum,
    idft3,
    kernel_spectrum_split,
    make_plan,
    set_matmul_precision,
)
from .core.fft import (
    KernelSpectrumCache,
    default_spectrum_cache,
    forward_kernel_spectrum,
    irfft3,
    rfft3,
)
from .core.kernels import (
    compute_quotient,
    final_values,
    regularized_final_values,
    rl_update,
)
from .core.wrap import wrap_kernel
from .deconv.dispatch import DispatchDivergenceWarning, deconvolve_auto
from .deconv.rl import deconvolve, deconvolve_jit, rl_view_step
from .deconv.streamed import deconvolve_streamed
from .deconv.workspace import MultiViewData, View, Workspace, initial_psi
from .models import RichardsonLucy, WienerFilter, wiener_deconvolve
from . import api, io
from .io.checkpoint import CheckpointManager

__version__ = "0.1.0"

__all__ = [
    "as_shape",
    "halo_widths",
    "kernel_center",
    "next_fast_shape",
    "zero_pad_extents",
    "zero_pad_offsets",
    "crop_at_offsets",
    "embed_at_offsets",
    "KernelSpectrumCache",
    "default_spectrum_cache",
    "forward_kernel_spectrum",
    "deconvolve_jit",
    "make_plan",
    "kernel_spectrum_split",
    "api",
    "io",
    "CheckpointManager",
    "View",
    "MultiViewData",
    "Workspace",
    "initial_psi",
    "deconvolve",
    "deconvolve_auto",
    "deconvolve_streamed",
    "DispatchDivergenceWarning",
    "RichardsonLucy",
    "WienerFilter",
    "wiener_deconvolve",
    "rl_view_step",
    "wrap_kernel",
    "rfft3",
    "irfft3",
    "convolve_spectrum",
    "fft_convolve3d",
    "direct_convolve3d",
    "convolve3d",
    "dft3",
    "idft3",
    "dft_convolve_spectrum",
    "set_matmul_precision",
    "compute_quotient",
    "final_values",
    "regularized_final_values",
    "rl_update",
]
