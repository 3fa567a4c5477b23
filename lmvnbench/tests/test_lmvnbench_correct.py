"""``correct`` is a comparison that fails: the control, a step below
float32, and each fault that a cell can have, drive the rest of a run on
the CPU (the look for a card skipped) and come out not correct; the
program as the configuration states it comes out correct."""

import io

import pytest
import torch

from lmvnbench.calibrate import reference_solver
from lmvnbench.manifest import Manifest
from lmvnbench.run import program_solver, run_cell

SINGLE = ("tiny_v4_256_pervoxel.tiny_single", "tiny_v4_512_adjoint.tiny_single")
BATCH = "tiny_v4_256_pervoxel.tiny_batch2"


def run(root, cell, solve_of, seed=2**31 + 11):
    m = Manifest(root)
    cfg = m.config(m.cell(cell)["config"])
    solve = solve_of(cfg) if solve_of else None
    r = run_cell(m, cell, seed, 0.1, False, device="cpu", solve=solve, out=io.StringIO())
    return r["line"], r["checks"]


@pytest.mark.parametrize("cell", SINGLE + (BATCH,))
def test_program_is_correct_and_reference_bf16_is_not(tiny_root, cell):
    line, checks = run(tiny_root, cell, None)
    assert line["correct"], checks
    line, checks = run(tiny_root, cell, lambda cfg: reference_solver(cfg, torch.bfloat16))
    assert not line["correct"]
    assert checks["psi_err"]["value"] > 3 * checks["psi_err"]["limit"]


@pytest.mark.parametrize("cell", SINGLE)
def test_program_bf16_path_is_not_correct(tiny_root, cell, monkeypatch):
    """The program's own bf16 path (the fused spectra stored as bfloat16),
    the control of the fused cells, fails the limit."""
    from libmultiviewnative_torch.deconv.dispatch import deconvolve_auto

    def fused(cfg):
        def solve(psi0, data):
            return deconvolve_auto(psi0, data, cfg["iterations"], lam=cfg["lam"],
                                   min_value=cfg["min_value"],
                                   adjoint_kernel2=cfg["adjoint_kernel2"], algorithm="fused",
                                   device="cpu")
        return solve

    line, checks = run(tiny_root, cell, fused)
    assert line["correct"], checks
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1")
    line, checks = run(tiny_root, cell, fused)
    assert not line["correct"]


def unchanged(cfg):
    return lambda psi0, data: psi0.clone()


def altered(cfg):
    solve = program_solver(cfg, torch.device("cpu"))

    def wrong(psi0, data):
        out = solve(psi0, data)
        flat = out.view(-1)
        flat[flat.numel() // 3] += 0.01 * out.abs().max()
        return out
    return wrong


def half_batch(cfg):
    solve = program_solver(cfg, torch.device("cpu"))

    def half(psi0, data):
        from libmultiviewnative_torch.deconv.workspace import MultiViewData

        h = psi0.shape[0] // 2
        out = psi0.clone()
        part = MultiViewData(data.views[:, :h], data.kernel1, data.kernel2, data.weights)
        out[:h] = solve(psi0[:h].contiguous(), part)
        return out
    return half


def failing(cfg):
    """Every request after the warm-up's one raises: a stack that never
    comes."""
    solve = program_solver(cfg, torch.device("cpu"))
    calls = []

    def boom(psi0, data):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted fault")
        return solve(psi0, data)
    return boom


@pytest.mark.parametrize("cell,fault", [
    (SINGLE[0], unchanged), (SINGLE[1], unchanged), (BATCH, unchanged),
    (SINGLE[0], altered), (BATCH, altered), (BATCH, half_batch), (SINGLE[1], failing),
])
def test_faults_are_not_correct(tiny_root, cell, fault, capsys):
    line, checks = run(tiny_root, cell, fault)
    assert not line["correct"], checks
    if fault is failing:
        assert line["failed"] >= 1 and checks["failed"]["value"] >= 1
