"""Wrappers of the hand-written CUDA kernels for the RL elementwise steps.

Counterpart of ``libmultiviewnative_tpu/ops/pallas/elementwise.py``; the
kernels are in ``ops/csrc/elementwise.cu``:

* K1 :func:`rl_update` replaces ``rl_update_pallas``
  (``ops/pallas/elementwise.py:68``): psi' = w·(clamp(f(psi·integral)) − psi)
  + psi.  16 bytes per voxel with a weight volume, 12 with a scalar weight.
  psi may be a batch of volumes (*B, Z, Y, X) against one weight volume
  (Z, Y, X) that the kernel reads once for the batch: 4n(3B + 1) bytes.
* K2 :func:`quotient` replaces ``quotient_pallas`` (:101): view · (1/integral),
  12 bytes per voxel; one view may serve a batch of integrals, read once:
  4n(2B + 1) bytes.
* K3 :func:`spectral_multiply` replaces ``spectral_multiply_pallas`` (:130):
  x̂·k̂ (or x̂·conj(k̂)) on interleaved complex64, the kernel spectrum
  broadcast over x̂'s leading axes; 24 bytes per complex value, the kernel
  spectrum read once for the whole batch.  It walks memory in order, so it
  takes any dense layout that x̂ and k̂ share: cuFFT's 3D rfftn returns a
  permuted one ((X//2+1, Z, Y) in memory), which is used as it comes.

Every one of them is bound by HBM bandwidth on the H100, so each is a single
pass that reads every input once and writes its output once, with 16-byte
vector accesses, and may write in place (``out=`` aliasing an input): the
driver updates psi and the quotient without extra volumes.

Dispatch: a tensor on the CPU goes to the plain PyTorch version (the
``*_plain`` functions, which the card's kernels are held against).  A CUDA
tensor launches the kernel, or raises; it never falls back.  Each launch
adds one to :data:`launches`.

Gradients.  When grad mode is on and an operand requires grad, each wrapper
runs through a ``torch.autograd.Function`` whose forward dispatches as
above, and ``out=`` is ignored: the result is a fresh tensor, since autograd
may need the operand that ``out`` would overwrite.  K3's backward is K3
itself (the conjugate product, then a sum over the broadcast axes); K1's and
K2's recompute the plain version's vjp from the saved inputs, as the JAX
package's Pallas kernels carry no backward of their own (``jax.grad`` goes
through jnp).  K1 is differentiable in psi, the integral, the weights
(a volume, a shared volume or a 0-dim tensor) and a 0-dim tensor λ; K2 in
both operands.  A shared operand's gradient is summed over the batch.  With
no operand requiring grad, as on the main path, nothing of this runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.kernels import compute_quotient, rl_update as _rl_update_plain
from ..utils.trace import check_kernel_output, spanned
from . import _build

# launch counts of the three kernels; a plain-version call never counts
launches = {"rl_update": 0, "quotient": 0, "spectral_multiply": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


rl_update_plain = _rl_update_plain
quotient_plain = compute_quotient


def spectral_multiply_plain(x_hat, k_hat, conj_k: bool = False) -> torch.Tensor:
    return x_hat * (k_hat.conj() if conj_k else k_hat)


def _device(*tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands are on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def _check(name: str, t, dtype: torch.dtype, shape=None, contiguous=True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.is_conj():
        # the data under a lazy conj view holds the UNconjugated numbers
        raise ValueError(f"{name} is a lazy conj() view; call resolve_conj() first")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _shared_batch(name: str, t: torch.Tensor, shape) -> int:
    """How many entries of a ``shape`` operand share ``t``, whose shape must
    be ``shape`` or a suffix of it."""
    shape = tuple(shape)
    if t.ndim > len(shape) or shape[len(shape) - t.ndim:] != tuple(t.shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape} or a suffix of it"
        )
    return max(1, int(torch.Size(shape[: len(shape) - t.ndim]).numel()))


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill one gap-free span, in any axis order."""
    expect = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _batched_strides(k: torch.Tensor, batch_shape) -> tuple:
    """Strides of ``batch_shape`` copies of ``k``'s layout, batch outermost."""
    n, outer = k.numel(), []
    for b in reversed(tuple(batch_shape)):
        outer.append(n)
        n *= b
    return tuple(reversed(outer)) + tuple(k.stride())


def _same_order(x: torch.Tensor, k: torch.Tensor) -> bool:
    want = _batched_strides(k, x.shape[: x.ndim - k.ndim])
    return all(a == b for a, b, n in zip(x.stride(), want, x.shape) if n != 1)


def layout_like(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x`` in the memory order K3 needs against ``k``: ``k``'s layout over
    the trailing axes, leading axes outermost.  ``x`` itself when it already
    is, else a copy."""
    if _same_order(x, k):
        return x
    out = torch.empty_strided(
        x.shape, _batched_strides(k, x.shape[: x.ndim - k.ndim]), dtype=x.dtype, device=x.device
    )
    return out.copy_(x)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _wants_grad(*operands) -> bool:
    """Whether autograd must see this call: grad mode on and some tensor
    operand requiring grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in operands
    )


def _plain_vjp(plain, inputs, needs, grad):
    """The vjp of ``plain(*inputs)`` against ``grad`` for the inputs that
    ``needs`` marks, recomputed from the inputs (None for the others, which
    may be Python numbers)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs)]
        res = plain(*leaves)
        got = iter(torch.autograd.grad(res, [t for t, n in zip(leaves, needs) if n], grad))
    return tuple(next(got) if n else None for n in needs)


@spanned("lmvn.engine.rl_update")
def rl_update(
    psi: torch.Tensor,
    integral: torch.Tensor,
    weights,
    lam,
    min_value: float,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1: the weighted, clamped RL update; ``out`` may be ``psi``.

    ``weights`` is a tensor of psi's shape, a tensor of a suffix of it (one
    weight volume shared by psi's leading batch entries, read once), or a
    scalar.  On the card ``lam``, ``min_value`` and a scalar weight are
    runtime float arguments (a 0-dim tensor is read back to the host first),
    so a λ sweep builds nothing new.  Differentiable in psi, the integral,
    a weight tensor and a 0-dim tensor ``lam``.
    """
    shape = tuple(psi.shape)
    _check("psi", psi, torch.float32)
    _check("integral", integral, torch.float32, shape)
    per_voxel = isinstance(weights, torch.Tensor) and weights.ndim > 0
    operands = [psi, integral]
    if per_voxel:
        _check("weights", weights, torch.float32)
        _shared_batch("weights", weights, shape)
        operands.append(weights)
    if out is not None:
        _check("out", out, torch.float32, shape)
        operands.append(out)
    dev = _device(*operands)
    if _wants_grad(psi, integral, weights, lam):
        return _RlUpdate.apply(psi, integral, weights, lam, min_value)
    return _rl_update(dev, psi, integral, weights, lam, min_value, out)


def _rl_update(dev, psi, integral, weights, lam, min_value, out):
    if dev.type == "cpu":
        res = rl_update_plain(psi, integral, weights, lam, min_value)
        return res if out is None else out.copy_(res)
    per_voxel = isinstance(weights, torch.Tensor) and weights.ndim > 0
    lib = _build.library()
    if out is None:
        out = torch.empty_like(psi)
    batch = _shared_batch("weights", weights, psi.shape) if per_voxel else 1
    err = lib.lmvn_rl_update(
        dev.index,
        out.data_ptr(),
        psi.data_ptr(),
        integral.data_ptr(),
        weights.data_ptr() if per_voxel else None,
        0.0 if per_voxel else float(weights),
        float(lam),
        float(min_value),
        psi.numel() // batch,
        batch,
        _stream(dev),
    )
    _build.check("rl_update", err)
    launches["rl_update"] += 1
    check_kernel_output("rl_update", out)
    return out


class _RlUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi, integral, weights, lam, min_value):
        tensor_or_none = [t if isinstance(t, torch.Tensor) else None for t in (weights, lam)]
        ctx.save_for_backward(psi, integral, *tensor_or_none)
        ctx.args = (weights, lam, min_value)
        return _rl_update(psi.device, psi, integral, weights, lam, min_value, None)

    @staticmethod
    def backward(ctx, grad):
        weights, lam, min_value = ctx.args
        psi, integral, w_t, lam_t = ctx.saved_tensors
        inputs = (psi, integral, weights if w_t is None else w_t, lam if lam_t is None else lam_t)
        plain = lambda p, i, w, l: rl_update_plain(p, i, w, l, min_value)  # noqa: E731
        return _plain_vjp(plain, inputs, ctx.needs_input_grad[:4], grad) + (None,)


@spanned("lmvn.engine.quotient")
def quotient(
    view: torch.Tensor, integral: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K2: view · (1/integral); ``out`` may be ``integral``.  ``view`` has
    the integral's shape or a suffix of it (one view shared by the
    integral's leading batch entries, read once).  Differentiable in both
    operands."""
    shape = tuple(integral.shape)
    _check("view", view, torch.float32)
    _check("integral", integral, torch.float32)
    _shared_batch("view", view, shape)
    operands = [view, integral]
    if out is not None:
        _check("out", out, torch.float32, shape)
        operands.append(out)
    dev = _device(*operands)
    if _wants_grad(view, integral):
        return _Quotient.apply(view, integral)
    return _quotient(dev, view, integral, out)


def _quotient(dev, view, integral, out):
    if dev.type == "cpu":
        res = quotient_plain(view, integral)
        return res if out is None else out.copy_(res)
    lib = _build.library()
    if out is None:
        out = torch.empty_like(integral)
    batch = _shared_batch("view", view, integral.shape)
    err = lib.lmvn_quotient(
        dev.index, out.data_ptr(), view.data_ptr(), integral.data_ptr(),
        view.numel(), batch, _stream(dev),
    )
    _build.check("quotient", err)
    launches["quotient"] += 1
    check_kernel_output("quotient", out)
    return out


class _Quotient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, view, integral):
        ctx.save_for_backward(view, integral)
        return _quotient(view.device, view, integral, None)

    @staticmethod
    def backward(ctx, grad):
        return _plain_vjp(quotient_plain, ctx.saved_tensors, ctx.needs_input_grad, grad)


def spectral_multiply(
    x_hat: torch.Tensor,
    k_hat: torch.Tensor,
    conj_k: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3: x̂·k̂, or x̂·conj(k̂) with ``conj_k``; ``out`` may be ``x_hat``.

    ``k_hat``'s shape must be a suffix of ``x_hat``'s: it is applied to every
    leading (batch) entry of ``x_hat`` without being materialised.  ``k_hat``
    may have any dense layout; ``x_hat`` and ``out`` must repeat it over the
    leading axes (:func:`layout_like` makes such a copy).  Differentiable in
    both operands; the backward launches K3 (:class:`_SpectralMultiply`).
    """
    _check("x_hat", x_hat, torch.complex64, contiguous=False)
    _check("k_hat", k_hat, torch.complex64, contiguous=False)
    kshape = tuple(k_hat.shape)
    if k_hat.ndim > x_hat.ndim or tuple(x_hat.shape[x_hat.ndim - k_hat.ndim:]) != kshape:
        raise ValueError(
            f"k_hat {kshape} must match the trailing axes of x_hat {tuple(x_hat.shape)}"
        )
    if not _dense(k_hat):
        raise ValueError("k_hat must be dense (no gaps between its elements)")
    operands = [x_hat, k_hat]
    if out is not None:
        _check("out", out, torch.complex64, x_hat.shape, contiguous=False)
        operands.append(out)
    for name, t in (("x_hat", x_hat), ("out", out)):
        if t is not None and not _same_order(t, k_hat):
            raise ValueError(f"{name} does not hold k_hat's memory order; see layout_like()")
    dev = _device(*operands)
    if _wants_grad(x_hat, k_hat):
        return _SpectralMultiply.apply(x_hat, k_hat, bool(conj_k))
    return _spectral_multiply(dev, x_hat, k_hat, conj_k, out)


def _spectral_multiply(dev, x_hat, k_hat, conj_k, out):
    if dev.type == "cpu":
        res = spectral_multiply_plain(x_hat, k_hat, conj_k)
        return res if out is None else out.copy_(res)
    lib = _build.library()
    if out is None:
        out = torch.empty_like(x_hat)
    nk = k_hat.numel()
    err = lib.lmvn_spectral_multiply(
        dev.index, out.data_ptr(), x_hat.data_ptr(), k_hat.data_ptr(),
        x_hat.numel() // max(nk, 1), nk, int(bool(conj_k)), _stream(dev),
    )
    _build.check("spectral_multiply", err)
    launches["spectral_multiply"] += 1
    check_kernel_output("spectral_multiply", out)
    return out


class _SpectralMultiply(torch.autograd.Function):
    """out = x̂·k̂ (or x̂·conj k̂), in PyTorch's convention for complex
    gradients (the conjugate Wirtinger derivative):

        grad_x = g·conj(k̂)                 (g·k̂ under conj_k)
        grad_k = Σ_batch g·conj(x̂)          (its conjugate under conj_k)

    Each product is one K3 call; the sum runs over x̂'s leading axes."""

    @staticmethod
    def forward(ctx, x_hat, k_hat, conj_k):
        ctx.save_for_backward(x_hat, k_hat)
        ctx.conj_k = conj_k
        return _spectral_multiply(x_hat.device, x_hat, k_hat, conj_k, None)

    @staticmethod
    def backward(ctx, grad):
        x_hat, k_hat = ctx.saved_tensors
        grad = grad.resolve_conj()
        g_x = g_k = None
        if ctx.needs_input_grad[0]:
            g_x = spectral_multiply(layout_like(grad, k_hat), k_hat, conj_k=not ctx.conj_k)
        if ctx.needs_input_grad[1]:
            g_k = spectral_multiply(layout_like(grad, x_hat), x_hat, conj_k=True)
            if x_hat.ndim > k_hat.ndim:  # sum(dim=()) would sum every axis
                g_k = g_k.sum(dim=tuple(range(x_hat.ndim - k_hat.ndim)))
            if ctx.conj_k:
                g_k = g_k.conj().resolve_conj()
        return g_x, g_k, None
