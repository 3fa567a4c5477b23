"""libmultiviewnative_torch — multi-view Richardson-Lucy deconvolution in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``libmultiviewnative_tpu`` (JAX), which stays the reference;
this package mirrors its layout and its public names.  It imports torch and
numpy, never jax.  Tensors on the CPU run the plain PyTorch versions of the
kernels; tensors on a CUDA device run the kernels of ``ops/csrc/``, built
with nvcc at first use.

Ported so far: ``deconvolve`` in both view orders, with prepared spectra and
convergence history, on two engines: ``"fft"`` (cuFFT and the elementwise
kernels K1-K3) and ``"fused"`` (the fused RL step at fp32, kernels K4-K10:
the five-pass chain, the carried four-pass chain with ``LMVN_FUSED_CARRY=1``
and the dense spectrum forwarding); and the interleaved out-of-core rung,
``deconv.interleaved.deconvolve_interleaved``, on both engines.
``algorithm="auto"`` means ``"fft"``.
"""

from .core.convolve import convolve_spectrum, fft_convolve3d
from .core.fft import irfft3, rfft3
from .core.kernels import (
    compute_quotient,
    final_values,
    regularized_final_values,
    rl_update,
)
from .core.wrap import wrap_kernel
from .deconv.rl import deconvolve, rl_view_step
from .deconv.workspace import MultiViewData, View, Workspace, initial_psi

__version__ = "0.1.0"

__all__ = [
    "View",
    "MultiViewData",
    "Workspace",
    "initial_psi",
    "deconvolve",
    "rl_view_step",
    "wrap_kernel",
    "rfft3",
    "irfft3",
    "convolve_spectrum",
    "fft_convolve3d",
    "compute_quotient",
    "final_values",
    "regularized_final_values",
    "rl_update",
]
