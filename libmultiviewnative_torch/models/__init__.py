"""Deconvolution model families.

Counterpart of ``libmultiviewnative_tpu/models``: the reference's one family,
sequential Bayesian multi-view Richardson-Lucy with optional Tikhonov
regularisation, as a configured model, and the closed-form multi-view
Wiener inversion the JAX package adds.
"""

from .richardson_lucy import RichardsonLucy
from .wiener import WienerFilter, wiener_deconvolve

__all__ = ["RichardsonLucy", "WienerFilter", "wiener_deconvolve"]
