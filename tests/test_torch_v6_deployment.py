"""The benchmark's 6-view light-sheet deployment
(``lmvnbench/configs/v6_300x1024x1024_pervoxel.json``: 6 views of
300 x 1024 x 1024, 21³/25³ kernels, per-voxel weights 1/6, λ 0.006, 10
iterations) on the path ``deconvolve_auto`` gives it on a card, checked on
the CPU.

* The engine: Z = 300 is no multiple of 8, so the fused engine cannot serve
  the shape and ``auto`` takes fft on a CUDA device.  Neither question
  touches a card.
* The ladder: the in-core estimate of the deployment, on meta tensors of its
  shapes, is 32 volumes (6 views, 6 weight volumes, 12 half-spectra, 8 of
  psi and temporaries), under the in-core cap of a card of 80 GB.
* The engine's arithmetic: the fft engine (torch.fft and K1-K3's plain
  versions here) against the benchmark's float64 plain reference
  (``lmvnbench/reference/rl.py``) at (30, 64, 64), whose Z keeps the
  deployment's two properties, no multiple of 8 and a mixed radix
  (2·3·5), with the configuration's kernels, weights, λ and iterations.
"""

import json
from pathlib import Path

import pytest
import torch

from lmvnbench import inputs, reference
from libmultiviewnative_torch.deconv import dispatch
from libmultiviewnative_torch.deconv.engines import _cuda_auto
from libmultiviewnative_torch.deconv.rl import deconvolve, fused_eligible, resolve_algorithm
from libmultiviewnative_torch.deconv.workspace import MultiViewData

torch.set_num_threads(1)

CONFIG = json.loads(
    (Path(__file__).resolve().parents[1] / "lmvnbench" / "configs"
     / "v6_300x1024x1024_pervoxel.json").read_text()
)
SHAPE = tuple(CONFIG["shape"])
V = CONFIG["views"]
SMALL = (30, 64, 64)
# The memory an NVIDIA H100 80GB HBM3 reports as its total through
# torch.cuda.mem_get_info, which deconvolve_auto reads for its cap.
H100_BYTES = 85_017_493_504
# The cell's own limit on psi_err (the configuration's "check"): the CPU
# engine reads about 1.1e-6 here, and the reference with every stored value
# rounded to bf16, a precision below float32, about 6.5e-2.
TOL = CONFIG["check"]["psi_err"]


def test_auto_takes_fft_on_a_card():
    cuda = torch.device("cuda")
    assert not fused_eligible(SHAPE, cuda)
    assert _cuda_auto(SHAPE, cuda, False) == "fft"
    assert resolve_algorithm("auto", SHAPE, cuda) == "fft"


def _meta_data() -> MultiViewData:
    meta = dict(device="meta", dtype=torch.float32)
    k1 = tuple(CONFIG["kernel1"]["shape"])
    k2 = tuple(CONFIG["kernel2_shape"])
    return MultiViewData(torch.empty((V,) + SHAPE, **meta), torch.empty((V,) + k1, **meta),
                         torch.empty((V,) + k2, **meta), torch.empty((V,) + SHAPE, **meta))


def test_ladder_keeps_the_deployment_in_core():
    vol = 4 * 300 * 1024 * 1024
    assert SHAPE == (300, 1024, 1024) and V == 6
    est = dispatch.estimate_workspace_bytes(_meta_data(), "auto", torch.device("cuda"))
    assert est == 32 * vol  # 6 views + 6 weights + 2·6 spectra + 8 of psi and temporaries
    assert est < int(0.9 * H100_BYTES)


def _problem(seed: int):
    cfg = dict(CONFIG, shape=list(SMALL))
    k1, k2 = inputs.kernels(cfg, "cpu")
    weights = inputs.weights(cfg, "cpu")
    views = inputs.stack_views(cfg, seed, 0, "cpu")
    psi0 = torch.full(SMALL, float(inputs.start_value(views)))
    ref = reference.deconvolve(psi0, views, k1, k2, weights, CONFIG["iterations"],
                               CONFIG["lam"], CONFIG["min_value"])
    return psi0, MultiViewData(views, k1, k2, weights), ref


def _err(got: torch.Tensor, ref: torch.Tensor) -> float:
    assert got.shape == ref.shape and torch.isfinite(got).all()
    return float((got.to(torch.float64) - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [2**31 + 21, 4_000_000_021])
def test_fft_engine_matches_reference(seed):
    psi0, data, ref = _problem(seed)
    got = deconvolve(psi0, data, CONFIG["iterations"], lam=CONFIG["lam"],
                     min_value=CONFIG["min_value"], algorithm="fft")
    assert _err(got, ref) <= TOL


def test_reference_in_bf16_fails_the_tolerance():
    psi0, data, ref = _problem(2**31 + 21)
    low = reference.deconvolve(psi0, data.views, data.kernel1, data.kernel2, data.weights,
                               CONFIG["iterations"], CONFIG["lam"], CONFIG["min_value"],
                               dtype=torch.float32, storage=torch.bfloat16)
    assert _err(low, ref) > 100 * TOL
