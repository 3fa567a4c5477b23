"""Mesh-sharded deconvolution over a ('view', 'z') grid of devices."""
