"""The fft engine's hand route (``ops/z_convolve.py``, ``ops/csrc/
z_convolve.cu``): cuFFT on x and y, one hand-written pass for the z FFT,
the product with the kernel spectrum, the inverse z FFT and 1/N.

On the CPU, where the route is never taken:

* its plain version (``z_pass_convolve_plain``: ``rfft2``, z ``fft``, the
  product, the unscaled z ``ifft``, 1/N, the unscaled ``irfft2``) against
  the 3D route (``rfft3``, K3's plain version, ``irfft3``) at Z of 12, 20,
  28 and 60, odd and even X, odd Y, with ``conj_k`` and a batch, to 1e-5 of
  max|·| (K4-K10's gate);
* a numpy emulation of the kernel (the natural-order load, the transposed
  forward stages of ``fft_stage.cuh``, the product with the kernel spectrum
  at ``pos[f]``, the inverse stages, 1/N) against ``z_convolve_plain``,
  through the stage emulation of tests/test_torch_fft_stages.py;
* the route rule (``takes_z_pass``): which shapes, dtypes and devices take
  it; the CPU, operands requiring grad, stacks of kernels and z lengths
  with a generic radix never do;
* the counter of ``core/convolve.py`` (``routes``) and its one
  ``[lmvn-trace]`` line a shape and route;
* the CUDA branch on CPU tensors with cuFFT and the kernel library replaced
  by recorders: the plans' layouts (the r2c writing (X//2+1, Z, Y) order),
  the five calls a convolution in their order, the kernel's arguments, one
  sequence a batch entry.

On the card, the tests marked ``card`` (skipped without an NVIDIA GPU):

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_z_convolve.py

hold the route and the kernel alone against the plain versions at small
shapes and at (300, 1024, 1024), 1e-5 of max|·|, each batch entry bitwise
its single call.  (``--noconftest``: tests/conftest.py imports JAX; this
file imports it only inside the emulation test.)
"""

import contextlib

import numpy as np
import pytest
import torch

from libmultiviewnative_torch.core import convolve as cv
from libmultiviewnative_torch.core.fft import irfft3, rfft3
from libmultiviewnative_torch.ops import elementwise as ew
from libmultiviewnative_torch.ops import fused_plan as fp
from libmultiviewnative_torch.ops import z_convolve as zc

torch.set_num_threads(1)

RTOL = 1e-5  # of max|·|, K4-K10's gate against their plain versions
# (Z, Y, X): radices 4·3, 4·5, 4·7 and 4·3·5 on z, even and odd X, odd Y
SHAPES = [(12, 8, 10), (20, 6, 9), (28, 5, 8), (60, 7, 11), (12, 9, 7)]


def _rel(got, want) -> float:
    """max|got - want| over max|want|, complex values as (re, im) pairs."""
    got, want = (torch.view_as_real(t) if t.is_complex() else t for t in (got, want))
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(shape, seed=0, batch=()):
    """A volume (or a batch of them) and the spectrum of a random kernel
    volume, as the engine forwards one."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(tuple(batch) + tuple(shape), generator=g)
    k = rfft3(torch.rand(shape, generator=g))
    return x, k


def _three_d(x, k, conj_k):
    """The parent's route: rfft3, K3's plain version, irfft3."""
    return irfft3(ew.spectral_multiply_plain(rfft3(x), k, conj_k), x.shape[-3:])


@pytest.mark.parametrize("conj_k", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_route_is_the_3d_route(shape, conj_k):
    x, k = _inputs(shape, seed=sum(shape))
    got = zc.z_pass_convolve_plain(x, k, conj_k)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, _three_d(x, k, conj_k)) <= RTOL


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_plain_route_of_a_batch_is_each_entry(shape):
    x, k = _inputs(shape, seed=3, batch=(3,))
    got = zc.z_pass_convolve_plain(x, k, True)
    for i in range(3):
        assert _rel(got[i], _three_d(x[i], k, True)) <= RTOL
        torch.testing.assert_close(got[i], zc.z_pass_convolve_plain(x[i], k, True),
                                   rtol=0, atol=1e-6 * float(got.abs().max()))


def _emulate_z_convolve(spec, k, conj_k, n):
    """z_convolve_kernel on every (k, y) column of a half spectrum (Z, Y,
    Kx): the natural-order load, run_stages_dif (frequency f at pos[f]),
    the product with the kernel spectrum's frequency f there, run_stages
    inverse, times 1/n."""
    from test_torch_fft_stages import _run_stages, _run_stages_dif

    Z = spec.shape[0]
    st = fp.make_fft_stages(Z)
    cols = spec.reshape(Z, -1).astype(np.complex64)
    kk = k.reshape(Z, -1).astype(np.complex64)
    buf = _run_stages_dif(st, cols)
    buf[st.pos] *= np.conj(kk) if conj_k else kk
    return (_run_stages(st, buf, True) * np.float32(1.0 / n)).reshape(spec.shape)


@pytest.mark.parametrize("conj_k", [False, True])
@pytest.mark.parametrize("Z", [12, 20, 28, 60, 280, 300])
def test_kernel_emulation_is_the_plain_z_step(Z, conj_k):
    shape = (Z, 6, 9)
    x, k = _inputs(shape, seed=Z)
    spec = torch.fft.rfft2(x)
    n = Z * 6 * 9
    got = _emulate_z_convolve(spec.numpy(), k.numpy(), conj_k, n)
    want = zc.z_convolve_plain(spec, k, conj_k, n)
    assert _rel(torch.from_numpy(got), want) <= RTOL


# ---------------------------------------------------------------- the rule


def test_z_lengths_the_pass_serves():
    """A direct plan of radices 2, 3, 4, 5, 7 and 8: every prime factor at
    most 7, up to the tile limit; a generic radix, a length of one and a
    length past the shared-memory stages keep the 3D route."""
    served = [2, 12, 20, 28, 60, 64, 128, 256, 280, 300, 343, 512, 1000, 1024, 4096, 14336]
    refused = [1, 11, 22, 276, 1021, 8168, 14528, 16384]
    assert all(zc.z_length_ok(z) for z in served)
    assert not any(zc.z_length_ok(z) for z in refused)


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors taken for the card's (the rule reads only the device)."""
    monkeypatch.setattr(zc, "_on_card", lambda t: True)


def test_the_cpu_never_takes_the_hand_route():
    x, k = _inputs((12, 8, 10))
    assert not zc.takes_z_pass(x, k)


def test_route_rule(on_card):
    x, k = _inputs((300, 4, 6))
    assert zc.takes_z_pass(x, k)
    assert zc.takes_z_pass(x[None].expand(2, -1, -1, -1), k)  # a batch, entry by entry
    assert zc.takes_z_pass(x, k.transpose(0, 1).contiguous().transpose(0, 1))  # any strides
    assert not zc.takes_z_pass(x, torch.stack([k, k]))  # a stack of kernels
    assert not zc.takes_z_pass(x.double(), k)
    assert not zc.takes_z_pass(x, k.to(torch.complex128))
    assert not zc.takes_z_pass(x, k.conj())  # a lazy conj view
    assert not zc.takes_z_pass(x[:, :, :5], k)  # X = 5 has Kx = 3, k has 4
    assert not zc.takes_z_pass(x[:, :1], k[:, :1])  # Y = 1
    x276, k276 = _inputs((276, 4, 6))  # 276 = 4·3·23: a generic radix
    assert not zc.takes_z_pass(x276, k276)
    assert not zc.takes_z_pass(x.clone().requires_grad_(), k)
    assert not zc.takes_z_pass(x, k.clone().requires_grad_())
    with torch.no_grad():  # nothing records a graph: the hand route serves
        assert zc.takes_z_pass(x.clone().requires_grad_(), k)


# ---------------------------------------------------------------- the counter


def test_routes_count_and_trace_once(monkeypatch, capsys):
    """One count a volume of output, on the route taken; under LMVN_TRACE one
    line the first time a shape takes a route, none after."""
    monkeypatch.setenv("LMVN_TRACE", "1")
    monkeypatch.setattr(cv, "_routes_seen", set())
    cv.reset_routes()
    x, k = _inputs((12, 8, 10), batch=(3,))
    cv.convolve_spectrum(x, k)  # a batch of 3 against one spectrum
    cv.convolve_spectrum(x[0], torch.stack([k, k]))  # one x against 2 kernels
    cv.convolve_spectrum(x[0], k, conj_k=True)
    assert cv.routes == {"z_pass": 0, "fft3": 6}
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "convolve_spectrum" in ln]
    assert lines == ["[lmvn-trace] convolve_spectrum: (12, 8, 10) on the fft3 route"]
    cv.reset_routes()
    assert cv.routes == {"z_pass": 0, "fft3": 0}


# ---------------------------------------------------------------- the main paths
# The engine's callers on CPU tensors taken for the card's, with the hand
# route computed by its plain version: which convolutions take it.


@pytest.fixture
def plain_card(monkeypatch, on_card):
    def z_pass(x, k, conj_k=False, out=None):
        res = zc.z_pass_convolve_plain(x, k, conj_k)
        return res if out is None else out.copy_(res)

    monkeypatch.setattr(cv, "z_pass_convolve", z_pass)
    cv.reset_routes()
    yield
    cv.reset_routes()


def _rl_data(shape, views=2, batch=(), seed=0):
    from libmultiviewnative_torch.deconv.workspace import MultiViewData
    from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

    g = np.random.default_rng(seed)
    vs = torch.from_numpy(g.gamma(2.0, 20.0, (views,) + tuple(batch) + shape).astype(np.float32))
    k1 = torch.from_numpy(np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v)
                                    for v in range(views)]))
    data = MultiViewData(vs, k1, torch.flip(k1, (1, 2, 3)), torch.full((views,), 1.0 / views))
    psi0 = vs.mean(dim=0)
    return data, psi0


@pytest.mark.parametrize("order,batch,z_pass,fft3", [
    ("sequential", (), 8, 0),  # 2 views, 2 iterations, 2 convolutions a view step
    ("sequential", (3,), 24, 0),  # each entry of the batch
    ("simultaneous", (), 0, 8),  # one x against the stacked spectra: the 3D route
    ("simultaneous", (3,), 24, 0),  # a batch meets the views one at a time
], ids=["seq", "seq-batch", "sim", "sim-batch"])
def test_deconvolve_routes(plain_card, order, batch, z_pass, fft3):
    """The fft engine on the card's route rule: the counts of each route,
    and psi within 1e-5 of max of the run on the 3D route alone."""
    from libmultiviewnative_torch.deconv import rl

    data, psi0 = _rl_data((12, 10, 9), batch=batch)
    got = rl.deconvolve(psi0, data, 2, lam=0.006, view_order=order, algorithm="fft")
    assert cv.routes == {"z_pass": z_pass, "fft3": fft3}
    zc_on_card = zc._on_card
    try:
        zc._on_card = lambda t: False
        want = rl.deconvolve(psi0, data, 2, lam=0.006, view_order=order, algorithm="fft")
    finally:
        zc._on_card = zc_on_card
    assert _rel(got, want) <= RTOL


def test_grad_takes_the_3d_route_from_the_first_operand_that_records(plain_card):
    """Weights and λ that require grad: the first view step's convolutions
    (psi0 and its quotient record nothing) take the hand route, every one
    after it the 3D route, whose K3 has a backward."""
    from libmultiviewnative_torch.deconv import rl

    data, psi0 = _rl_data((12, 10, 9))
    data = type(data)(data.views, data.kernel1, data.kernel2,
                      data.weights.clone().requires_grad_())
    lam = torch.tensor(0.006, requires_grad=True)
    out = rl.deconvolve(psi0, data, 2, lam=lam, algorithm="fft")
    assert cv.routes == {"z_pass": 2, "fft3": 6}
    out.sum().backward()
    assert data.weights.grad is not None and lam.grad is not None


# ---------------------------------------------------------------- the CUDA branch
# On CPU tensors, with cuFFT and the kernel library replaced by recorders:
# what the route asks of them, in what order.  Nothing is computed.


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        entry.__name__ = name
        return entry


@pytest.fixture
def fake_card(monkeypatch, on_card):
    cufft, lib, plans = _Recorder(), _Recorder(), []
    monkeypatch.setattr(zc, "_cufft", lambda: cufft)
    monkeypatch.setattr(zc._build, "library", lambda: lib)
    monkeypatch.setattr(zc, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    def plan_many(*args):
        plans.append(args)
        return len(plans), 4096 * len(plans)

    monkeypatch.setattr(zc, "_plan_many", plan_many)
    monkeypatch.setattr(zc, "_plans", type(zc._plans)())
    zc.reset_launches()
    cv.reset_routes()
    yield cufft, lib, plans
    zc.reset_launches()
    cv.reset_routes()


def test_cuda_route_plans_and_calls(fake_card):
    cufft, lib, plans = fake_card
    Z, Y, X = 300, 6, 9
    x, k = _inputs((Z, Y, X))
    out = cv.convolve_spectrum(x, k, conj_k=True)
    assert out.shape == (Z, Y, X) and out.dtype == torch.float32
    Kx = X // 2 + 1
    R2C, C2C, C2R = zc._CUFFT_R2C, zc._CUFFT_C2C, zc._CUFFT_C2R
    # (n, inembed, istride, idist, onembed, ostride, odist, type, batch): the
    # r2c writes frequency k of row (z, y) at k·Z·Y + z·Y + y
    assert plans == [(X, X, 1, X, Kx, Z * Y, 1, R2C, Z * Y),
                     (Y, Y, 1, Y, Y, 1, Y, C2C, Kx * Z),
                     (X, Kx, Z * Y, 1, X, 1, X, C2R, Z * Y)]
    execs = [(n, a) for n, a in cufft.calls if n.startswith("cufftExec")]
    assert [(n, a[0]) + a[3:] for n, a in execs] == [
        ("cufftExecR2C", 1), ("cufftExecC2C", 2, zc._CUFFT_FORWARD),
        ("cufftExecC2C", 2, zc._CUFFT_INVERSE), ("cufftExecC2R", 3)]
    (r2c, fwd, inv, c2r) = (a for _, a in execs)
    spec = r2c[2]
    assert r2c[1] == x.data_ptr() and fwd[1] == fwd[2] == inv[1] == inv[2] == c2r[1] == spec
    assert c2r[2] == out.data_ptr()
    areas = {a[1] for n, a in cufft.calls if n == "cufftSetWorkArea"}
    assert len(areas) == 1 and None not in areas  # one area, the largest plan's 3·4096 B
    [(name, args)] = lib.calls
    assert name == "lmvn_z_convolve"
    assert args[1] == spec and args[2] == k.data_ptr()
    assert args[3:7] == (*k.stride(), 1)  # k's (z, y, k) strides, conj_k
    assert args[8:10] == (Y, Kx) and args[10] == pytest.approx(1.0 / (Z * Y * X))
    assert zc.launches == {"z_convolve": 1} and cv.routes == {"z_pass": 1, "fft3": 0}


def test_cuda_route_takes_a_batch_entry_by_entry(fake_card):
    cufft, lib, plans = fake_card
    x, k = _inputs((20, 6, 8), batch=(2, 2))
    out = cv.convolve_spectrum(x, k)
    assert out.shape == x.shape
    assert len(plans) == 3  # one set of plans for the shape
    inputs = [a[1] for n, a in cufft.calls if n == "cufftExecR2C"]
    outputs = [a[2] for n, a in cufft.calls if n == "cufftExecC2R"]
    flat = x.reshape(4, 20, 6, 8)
    assert inputs == [e.data_ptr() for e in flat]
    assert outputs == [o.data_ptr() for o in out.reshape(4, 20, 6, 8)]
    assert [n for n, _ in lib.calls] == ["lmvn_z_convolve"] * 4
    assert zc.launches == {"z_convolve": 4} and cv.routes == {"z_pass": 4, "fft3": 0}


def test_cuda_route_left_for_grad_and_stacks(fake_card):
    """A graph to record, or a stack of kernels against one x: the 3D route
    (here the CPU's own transforms), nothing recorded."""
    cufft, lib, _ = fake_card
    x, k = _inputs((20, 6, 8))
    cv.convolve_spectrum(x.clone().requires_grad_(), k)
    cv.convolve_spectrum(x, torch.stack([k, k]))
    assert cufft.calls == [] and lib.calls == []
    assert cv.routes == {"z_pass": 0, "fft3": 3}


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only there")
    return torch.device("cuda", 0)


CARD_SHAPES = SHAPES + [(64, 64, 64), (280, 40, 33), (300, 1024, 1024)]


@pytest.mark.card
@pytest.mark.parametrize("conj_k", [False, True])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_card_route_against_plain(cuda, shape, conj_k):
    """The route within 1e-5 of max of its plain version and of the 3D
    route on the card; the kernel alone within 1e-5 of max of the plain z
    step, on the same x/y spectrum."""
    x, k = (t.to(cuda) for t in _inputs(shape, seed=len(shape) + shape[0]))
    assert zc.takes_z_pass(x, k)
    got = zc.z_pass_convolve(x, k, conj_k)
    assert _rel(got, zc.z_pass_convolve_plain(x, k, conj_k)) <= RTOL
    assert _rel(got, cv._fft3_convolve(x, k, conj_k)) <= RTOL
    Z, Y, X = shape
    spec = torch.fft.rfft2(x)
    ordered = torch.empty_strided(spec.shape, (Y, 1, Z * Y), dtype=spec.dtype, device=cuda)
    ordered.copy_(spec)
    want = zc.z_convolve_plain(spec, k, conj_k, Z * Y * X)
    assert _rel(zc.z_convolve(ordered, k, conj_k, shape), want) <= RTOL


@pytest.mark.card
def test_card_batch_entries_are_their_single_calls(cuda):
    x, k = (t.to(cuda) for t in _inputs((300, 64, 48), batch=(3,)))
    before = zc.launches["z_convolve"]
    got = cv.convolve_spectrum(x, k, conj_k=True)
    assert zc.launches["z_convolve"] == before + 3
    for i in range(3):
        assert torch.equal(got[i], cv.convolve_spectrum(x[i], k, conj_k=True))
