"""The plain reference, which makes each kernel spectrum when its view step
needs it and updates in place, is bit for bit the formulation that held
every spectrum and widened copies of the views and weights: that
formulation is kept here word for word (``oracle_*``) and the two are held
``torch.equal`` at 16³ to 32³ on the CPU, over per-voxel, per-entry and
per-view weights, the full and the adjoint kernel2, one volume and a batch
of 2, λ = 0.006 and λ = 0, zeros that drive the ``min_value`` and
non-finite branches, and the bf16 control's rounding.

On the card (tests marked ``card``, skipped without an NVIDIA GPU):

    python3 -m pytest -p no:cacheprovider -s -m card lmvnbench/tests/test_lmvnbench_reference_bitwise.py

the same at the 6-view configuration's size (2 iterations) and on a small
batch, and ``lmvnbench.run.check_results`` at 4 views of (256, 1024, 2048)
with per-voxel weights and two kept results, within 60 GiB of the card.
"""

import itertools
import json
import math
import time
import types
from pathlib import Path
from typing import Optional

import pytest
import torch

from lmvnbench import inputs, reference
from lmvnbench.run import check_results

ROOT = Path(__file__).resolve().parents[2]
GIB = 2**30


# The formulation before spectra were made per view step, word for word.

def oracle_wrap_kernel(kernel: torch.Tensor, shape, dtype) -> torch.Tensor:
    buf = torch.zeros(tuple(shape), dtype=dtype, device=kernel.device)
    buf[tuple(slice(0, s) for s in kernel.shape)] = kernel.to(dtype)
    return torch.roll(buf, shifts=[-(s // 2) for s in kernel.shape], dims=(0, 1, 2))


def oracle_final_values(psi, integral, weight, lam: float, min_value: float):
    value = psi * integral
    if lam > 0.0:
        candidate = (torch.sqrt(1.0 + 2.0 * lam * value) - 1.0) / lam
    else:
        candidate = value
    value = torch.where(value > 0.0, candidate, torch.full_like(value, min_value))
    nxt = torch.where(torch.isfinite(value), torch.clamp(value, min=min_value),
                      torch.full_like(value, min_value))
    return weight * (nxt - psi) + psi


def oracle_rounder(storage: Optional[torch.dtype], dtype: torch.dtype):
    if storage is None:
        return lambda t: t

    def rnd(t: torch.Tensor) -> torch.Tensor:
        if t.is_complex():
            return torch.view_as_complex(torch.view_as_real(t).to(storage).to(dtype))
        return t.to(storage).to(dtype)

    return rnd


def oracle_deconvolve(psi0, views, kernel1, kernel2, weights, iterations: int, lam: float,
                      min_value: float, adjoint_kernel2: bool = False,
                      dtype: torch.dtype = torch.float64,
                      storage: Optional[torch.dtype] = None) -> torch.Tensor:
    shape = tuple(psi0.shape[-3:])
    rnd = oracle_rounder(storage, dtype)
    dims = (-3, -2, -1)

    def spectrum(k):
        return rnd(torch.fft.rfftn(oracle_wrap_kernel(k, shape, dtype)))

    def convolve(x, k_hat):
        return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * k_hat, s=shape, dim=dims)

    k1_hat = [spectrum(k) for k in kernel1]
    second = [torch.flip(k, (0, 1, 2)) for k in kernel1] if adjoint_kernel2 else kernel2
    k2_hat = [spectrum(k) for k in second]
    psi = rnd(psi0.to(dtype))
    for _ in range(iterations):
        for v in range(len(k1_hat)):
            view = rnd(views[v].to(dtype))
            weight = rnd(weights[v].to(dtype))
            integral = rnd(convolve(psi, k1_hat[v]))
            integral = rnd(view / integral)
            integral = rnd(convolve(integral, k2_hat[v]))
            psi = rnd(oracle_final_values(psi, integral, weight, lam, min_value))
    return psi


def make_case(shape, k1s, k2s, adjoint, weights, batch, seed, device="cpu", views=3,
              zeros=None):
    """Inputs from the benchmark's own recipe; weights random in [0, 1)
    (``per_view`` (V,), ``per_voxel`` (V, Z, Y, X), ``per_entry`` (V, B, Z,
    Y, X)).  ``zeros``: ``"view"`` zeroes a slab of view 0 (values at or
    below 0 after the second convolution: the ``min_value`` branch);
    ``"psi"`` also starts from psi0 = 0 (a quotient of x / 0: the
    non-finite branch)."""
    cfg = {"shape": list(shape), "views": views,
           "kernel1": {"shape": list(k1s), "sigma0": 1.0, "sigma_step": 0.4},
           "kernel2_shape": list(k2s), "adjoint_kernel2": adjoint, "weights": "per_view",
           "view_gamma": {"shape": 2, "scale": 20.0}}
    k1, k2 = inputs.kernels(cfg, device)
    stacks = [inputs.stack_views(cfg, seed, t, device) for t in range(batch)]
    if zeros is not None:
        stacks[0][0, :, : shape[1] // 2] = 0.0
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lead = {"per_view": (views,), "per_voxel": (views, *shape),
            "per_entry": (views, batch, *shape)}[weights]
    w = torch.rand(lead, generator=g, dtype=torch.float32, device=device)
    if batch == 1:
        v, psi0 = stacks[0], torch.full(shape, float(stacks[0].mean()), device=device)
    else:
        v = torch.stack(stacks, dim=1)
        psi0 = torch.stack([torch.full(shape, float(s.mean()), device=device) for s in stacks])
    if zeros == "psi":
        psi0.zero_()
    return psi0, v, k1, k2, w


CASES = [
    dict(weights=w, adjoint=a, batch=b, lam=lam)
    for w, a, b, lam in itertools.product(("per_voxel", "per_view"), (False, True), (1, 2),
                                          (0.006, 0.0))
] + [
    dict(weights="per_entry", adjoint=False, batch=2, lam=0.006),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, zeros="view"),
    dict(weights="per_view", adjoint=True, batch=2, lam=0.0, zeros="view"),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, zeros="psi"),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, storage=torch.bfloat16,
         dtype=torch.float32),
    dict(weights="per_view", adjoint=True, batch=2, lam=0.0, storage=torch.bfloat16,
         dtype=torch.float32),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, storage=torch.bfloat16),
    dict(weights="per_voxel", adjoint=False, batch=2, lam=0.006, given=torch.float64,
         dtype=torch.float32),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, shape=(32, 32, 32),
         k1s=(21, 21, 21), k2s=(25, 25, 25)),
    dict(weights="per_view", adjoint=True, batch=1, lam=0.006, shape=(16, 24, 20),
         k1s=(5, 3, 7), k2s=(5, 3, 7)),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, shape=(20, 16, 17),
         k1s=(20, 5, 17), k2s=(20, 7, 17)),
]


def _id(c):
    return "-".join(f"{k}={getattr(v, '__name__', None) or str(v).replace('torch.', '')}"
                    for k, v in c.items())


def run_both(c, device="cpu", iterations=3):
    shape = c.get("shape", (16, 16, 16))
    args = make_case(shape, c.get("k1s", (5, 5, 5)), c.get("k2s", (7, 7, 7)), c["adjoint"],
                     c["weights"], c["batch"], seed=2**31 + 17, device=device,
                     zeros=c.get("zeros"))
    if "given" in c:  # views and weights handed over in another dtype than the loop's
        args = (args[0], args[1].to(c["given"]), args[2], args[3], args[4].to(c["given"]))
    opts = dict(adjoint_kernel2=c["adjoint"], dtype=c.get("dtype", torch.float64),
                storage=c.get("storage"))
    want = oracle_deconvolve(*args, iterations, c["lam"], 1e-4, **opts)
    got = reference.deconvolve(*args, iterations, c["lam"], 1e-4, **opts)
    return got, want, args


@pytest.mark.parametrize("c", CASES, ids=[_id(c) for c in CASES])
def test_reference_is_bitwise_the_oracle(c):
    got, want, args = run_both(c)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if c.get("zeros") == "psi":  # every voxel took the non-finite branch
        assert bool(torch.isfinite(got).all())


def test_inputs_are_left_as_they_were():
    c = dict(weights="per_voxel", adjoint=False, batch=2, lam=0.006)
    args = make_case((16, 16, 16), (5, 5, 5), (7, 7, 7), False, "per_voxel", 2, seed=5)
    before = [a.clone() for a in args]
    reference.deconvolve(*args, 2, c["lam"], 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.parametrize("k,n", [(5, 16), (16, 16), (1, 7), (7, 8)])
def test_wrap_kernel_is_the_rolled_corner(k, n):
    g = torch.Generator().manual_seed(k * n)
    kernel = torch.rand((k, max(k - 2, 1), k), generator=g)
    shape = (n, n + 3, n + 1)
    assert torch.equal(reference.wrap_kernel(kernel, shape, torch.float64),
                       oracle_wrap_kernel(kernel, shape, torch.float64))


# On the card.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the check's sizes only fit there")
    return torch.device("cuda", 0)


def _config(name):
    return json.loads((ROOT / "lmvnbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.card
def test_card_v6_size_is_bitwise_the_oracle(cuda):
    """The 6-view configuration at its size, one time point, 2 iterations:
    the new reference and the oracle agree bit for bit; each one's peak and
    seconds are printed."""
    cfg = _config("v6_300x1024x1024_pervoxel")
    k1, k2 = inputs.kernels(cfg, cuda)
    w = inputs.weights(cfg, cuda)
    views = inputs.stack_views(cfg, 2**31 + 3, 0, cuda)
    psi0 = torch.empty(tuple(cfg["shape"]), dtype=torch.float32, device=cuda)
    psi0.fill_(inputs.start_value(views))
    args = (psi0, views, k1, k2, w, 2, cfg["lam"], cfg["min_value"], cfg["adjoint_kernel2"])
    out = {}
    for name, fn in (("new", reference.deconvolve), ("oracle", oracle_deconvolve)):
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        t = time.perf_counter()
        out[name] = fn(*args)
        torch.cuda.synchronize(cuda)
        print(f"v6 size, 2 iterations, {name}: {time.perf_counter() - t:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated(cuda) / GIB:.4f} GiB "
              f"({base / GIB:.4f} GiB held before)")
    assert torch.equal(out["new"], out["oracle"])


@pytest.mark.card
@pytest.mark.parametrize("c", [
    dict(weights="per_entry", adjoint=False, batch=2, lam=0.006, shape=(64, 96, 80)),
    dict(weights="per_view", adjoint=True, batch=2, lam=0.0, shape=(64, 96, 80), zeros="view"),
    dict(weights="per_voxel", adjoint=False, batch=1, lam=0.006, shape=(40, 64, 48),
         storage=torch.bfloat16, dtype=torch.float32),
], ids=["batch-per-entry", "batch-adjoint-zeros", "bf16-control"])
def test_card_small_cases_are_bitwise_the_oracle(cuda, c):
    got, want, _ = run_both(dict(c, k1s=(21, 21, 21), k2s=(25, 25, 25)), device=cuda,
                            iterations=2)
    assert torch.equal(got, want)


@pytest.mark.card
def test_card_frame_check_fits(cuda):
    """``check_results`` at 4 views of (256, 1024, 2048), per-voxel weights,
    10 iterations, with two kept float32 results on the card: it completes
    within 60 GiB."""
    cfg = dict(_config("v4_256_pervoxel"), shape=[256, 1024, 2048])
    kept = {k: torch.full(tuple(cfg["shape"]), 40.0, device=cuda) for k in range(2)}
    loop = types.SimpleNamespace(batch=1, time_points=lambda k: [k])
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    t = time.perf_counter()
    found = check_results(cfg, loop, kept, 2**31 + 29, cuda, lambda m: print("#", m))
    torch.cuda.synchronize(cuda)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(cuda)
    print(f"frame check: {seconds:.3f} s for 2 kept stacks, peak {peak / GIB:.4f} GiB")
    assert found["compared"] == 2 and math.isfinite(found["psi_err"])
    assert peak <= 60 * GIB
