"""Ring halo exchange and overlap-save block convolution along a z axis
split over the cells of a mesh.

Counterpart of ``libmultiviewnative_tpu/parallel/halo.py``.  A global
circular convolution decomposes exactly into per-block overlap-save with a
ring halo exchange: block 0's lower halo is the last block's top planes,
which is the global wrap.  Each cell convolves its halo-extended block
(extent Bz + k - 1) circularly and keeps the central Bz planes, which never
touch the block-edge wrap.  Halo widths follow the kernel centre c = k//2
(``inc/padd_utils.h:25-27``): ``lo = k-1-c`` planes from the previous
block, ``hi = c`` from the next (:func:`..core.shapes.halo_widths`).

Blocks travel as dicts ``{(view, z): tensor}`` of this process's cells of a
mesh (:class:`.sharded.Mesh`).  Between two local cells a halo is a tensor
copy (peer to peer between cards); between processes it goes through
``torch.distributed.batch_isend_irecv``.  Every halo is sliced from the old
blocks before any new block is built, so cells that share one device never
read a half-written neighbour.

The convolves run the port's engines: :func:`convolve_zblock` the rfft
convolve through K3, :func:`convolve_zblock_dft` the matmul DFT, and
:func:`convolve_zblock_fused` the fused engine's passes A, B, C (K4, K6, K7)
at the 8-aligned extent.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..core.convolve import convolve_spectrum
from ..core.dft import dft_convolve_spectrum, kernel_spectrum_split
from ..core.fft import rfft3
from ..core.shapes import halo_widths
from ..core.wrap import wrap_kernel
from ..ops.fused import fused_convolve_transposed, kernel_spectrum_fused

Cell = Tuple[int, int]
Blocks = Dict[Cell, torch.Tensor]


def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]  # send to the next block
    bwd = [(i, (i - 1) % n) for i in range(n)]  # send to the previous block
    return fwd, bwd


def _exchange(send: Blocks, mesh, perm, kind: int) -> Blocks:
    """``{receiver cell: the block its sender sent}`` for the local
    receivers of a z ring permutation ``perm`` (pairs of z indices).  Local
    pairs copy; the pairs between processes are matched in one global order,
    tagged by sender cell and ``kind``."""
    vp, zp = mesh.shape["view"], mesh.shape["z"]
    like = next(iter(send.values()))
    got, ops, pending = {}, [], []
    for v in range(vp):
        for zs, zr in perm:
            src, dst = (v, zs), (v, zr)
            local_src, local_dst = mesh.is_local(src), mesh.is_local(dst)
            if local_src and local_dst:
                got[dst] = send[src].to(mesh.device(dst))
            elif local_src or local_dst:
                tag = 2 * (v * zp + zs) + kind
                if local_src:
                    ops.append(dist.P2POp(dist.isend, send[src].contiguous(), mesh.rank_of(dst),
                                          tag=tag))
                else:
                    buf = torch.empty(like.shape, dtype=like.dtype, device=mesh.device(dst))
                    ops.append(dist.P2POp(dist.irecv, buf, mesh.rank_of(src), tag=tag))
                    pending.append((dst, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got.update(pending)
    return got


def halo_exchange_z(blocks: Blocks, lo: int, hi: int, mesh) -> Blocks:
    """Extend each local (..., Bz, Y, X) block by ring-exchanged z halos:
    ``lo`` planes from the previous block (its top planes), ``hi`` from the
    next (its bottom planes).  The ring wraps, which gives the global
    circular boundary."""
    fwd, bwd = _ring_perms(mesh.shape["z"])
    zax = -3
    lower = upper = {}
    if lo > 0:
        tops = {c: b.narrow(zax, b.shape[zax] - lo, lo) for c, b in blocks.items()}
        lower = _exchange(tops, mesh, fwd, 0)
    if hi > 0:
        bottoms = {c: b.narrow(zax, 0, hi) for c, b in blocks.items()}
        upper = _exchange(bottoms, mesh, bwd, 1)
    if not lower and not upper:
        return dict(blocks)
    return {
        c: torch.cat([t for t in (lower.get(c), b, upper.get(c)) if t is not None], dim=zax)
        for c, b in blocks.items()
    }


def _ext(kernel_shape, local_spatial) -> Tuple[int, int, int]:
    (lo_z, _, _), (hi_z, _, _) = halo_widths(tuple(kernel_shape))
    return (int(local_spatial[0]) + lo_z + hi_z, int(local_spatial[1]), int(local_spatial[2]))


def zblock_kernel_spectrum(kernel: torch.Tensor, local_spatial) -> torch.Tensor:
    """A PSF forwarded for halo-extended blocks: wrap and rfft at extent
    (Bz + k - 1, Y, X)."""
    return rfft3(wrap_kernel(kernel.to(torch.float32), _ext(kernel.shape, local_spatial)))


def zblock_kernel_spectrum_split(kernel: torch.Tensor, local_spatial):
    """The (re, im) spectrum of the matmul-DFT engine at the halo-extended
    extent."""
    return kernel_spectrum_split(kernel, _ext(kernel.shape, local_spatial))


def _for_cell(spectrum, cell: Cell, device: torch.device):
    """A cell's spectrum: ``spectrum[cell]`` from a dict, else the one
    spectrum (a tensor or an (re, im) pair) on the cell's device."""
    if isinstance(spectrum, dict):
        return spectrum[cell]
    if isinstance(spectrum, (tuple, list)):
        return tuple(s.to(device) for s in spectrum)
    return spectrum.to(device)


def _crop(out: torch.Tensor, lo: int, bz: int) -> torch.Tensor:
    return out.narrow(-3, lo, bz).contiguous()


def convolve_zblock(blocks: Blocks, kernel_hat_ext, lo: int, hi: int, mesh) -> Blocks:
    """Overlap-save circular convolution of a z-split volume.

    ``blocks``: this process's (..., Bz, Y, X) blocks by cell;
    ``kernel_hat_ext``: the spectrum at the halo-extended extent
    (:func:`zblock_kernel_spectrum`), one tensor or a dict by cell.  Planes
    [lo, lo + Bz) of each extended convolve are exact: the zero_padd
    ``offsets_`` arithmetic (``inc/padd_utils.h:121-146``) lifted to
    blocks."""
    out = {}
    for c, e in halo_exchange_z(blocks, lo, hi, mesh).items():
        bz = blocks[c].shape[-3]
        out[c] = _crop(convolve_spectrum(e, _for_cell(kernel_hat_ext, c, e.device)), lo, bz)
    return out


def convolve_zblock_dft(blocks: Blocks, kernel_split_ext, lo: int, hi: int, mesh) -> Blocks:
    """:func:`convolve_zblock` with the matmul-DFT engine (split spectra
    from :func:`zblock_kernel_spectrum_split`)."""
    out = {}
    for c, e in halo_exchange_z(blocks, lo, hi, mesh).items():
        bz = blocks[c].shape[-3]
        k_re, k_im = _for_cell(kernel_split_ext, c, e.device)
        out[c] = _crop(dft_convolve_spectrum(e, k_re, k_im), lo, bz)
    return out


def zblock_fused_extent(bz: int, lo: int, hi: int) -> int:
    """The fused engine's z extent for a halo-extended block: Bz + lo + hi
    rounded up to a multiple of 8 (the engine's every axis is).  The pad
    planes are zeros below the extended block; output planes [lo, lo + Bz)
    of the circular convolve at the padded extent never read past plane
    Bz + lo + hi - 1, so the pad changes nothing."""
    ext = bz + lo + hi
    return -(-ext // 8) * 8


def zblock_kernel_spectrum_fused(kernel: torch.Tensor, local_spatial):
    """The fused-layout (Kxp, Z, Y) (re, im) spectrum at the padded
    halo-extended extent (:func:`zblock_fused_extent`)."""
    (lo_z, _, _), (hi_z, _, _) = halo_widths(tuple(kernel.shape))
    ze = zblock_fused_extent(int(local_spatial[0]), lo_z, hi_z)
    return kernel_spectrum_fused(kernel, (ze, int(local_spatial[1]), int(local_spatial[2])))


def convolve_zblock_fused(blocks_t: Blocks, kernel_fused_ext, lo: int, hi: int, mesh,
                          conj_k: bool = False) -> Blocks:
    """Overlap-save circular convolution with the fused engine, on
    TRANSPOSED (Bz, X, Y) blocks (the engine's (Z, X, Y) domain; callers
    transpose once outside the iterations).  The halo-extended block is
    zero-padded to the 8-aligned extent, convolved there by passes A, B, C
    (K4, K6, K7, :func:`..ops.fused.fused_convolve_transposed`), and the
    central [lo, lo + Bz) planes kept."""
    out = {}
    for c, e in halo_exchange_z(blocks_t, lo, hi, mesh).items():
        bz = blocks_t[c].shape[-3]
        pad = zblock_fused_extent(bz, lo, hi) - e.shape[-3]
        if pad:
            e = torch.cat([e, e.new_zeros((pad,) + tuple(e.shape[-2:]))], dim=-3)
        k_re, k_im = _for_cell(kernel_fused_ext, c, e.device)
        out[c] = _crop(fused_convolve_transposed(e, k_re, k_im, conj_k=conj_k), lo, bz)
    return out
