"""A batch on the fused engine (``deconv/rl.py`` ``_deconvolve_fused``): the
kernel spectra forwarded once a call, then each entry of psi (*B, Z, Y, X)
through the single-volume sweeps, named by one ``LMVN_TRACE`` line a call;
and the ladder's estimate of such a batch, which counts one entry's
temporaries and the input and output of the others.

The CPU tests run the passes' plain versions at 16³.  The entries against
the JAX package are in tests/test_torch_batched.py; this file imports no
JAX, so that its tests marked ``card`` run on the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_fused_batch.py

There each entry of a fused batch is held bitwise to the single fused call
on it: a batch of 2 at 64³ (shared views, per-voxel weights) through
``deconvolve(algorithm="fused")``, and ``deconvolve_auto`` on a (2, 256³)
batch, which the H100 table sends to fused as it sends one 256³ volume.
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_torch.deconv import dispatch, rl
from libmultiviewnative_torch.deconv.workspace import MultiViewData
from libmultiviewnative_torch.utils.synthetic import gaussian_kernel

torch.set_num_threads(1)

V = 2
KW = dict(lam=0.006, min_value=1e-4)
LINE = "deconvolve: a batch of {} on fused, entry by entry"


def _data(shape, batch, device, seed=0, views=V):
    """psi0 (batch, *shape), shared views, kernels 5³ and per-voxel weights
    that sum to 1 over the views."""
    rng = np.random.default_rng(seed)
    vs = rng.gamma(2.0, 20.0, (views,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.25 * v) for v in range(views)])
    w = rng.uniform(0.5, 1.5, (views,) + shape).astype(np.float32)
    w /= w.sum(axis=0, keepdims=True)
    psi0 = (vs.mean() * rng.uniform(0.8, 1.2, (batch,) + shape)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(psi0), MultiViewData(t(vs), t(k1), t(np.flip(k1, axis=(1, 2, 3))), t(w))


def test_trace_line_and_one_forwarding_a_call(monkeypatch, capsys):
    """A batched fused call prints one line under ``LMVN_TRACE``, naming its
    entries, and forwards the kernels once; a single volume and a batch on
    another engine print no such line."""
    psi0, data = _data((16,) * 3, 3, "cpu")
    calls = []
    forward = rl._forward_spectra

    def counted(*a, **k):
        calls.append(a[0])
        return forward(*a, **k)

    monkeypatch.setattr(rl, "_forward_spectra", counted)
    monkeypatch.setenv("LMVN_TRACE", "1")
    rl.deconvolve(psi0, data, 1, algorithm="fused", **KW)
    assert capsys.readouterr().out.count(LINE.format(3)) == 1
    assert calls == ["fused"]
    rl.deconvolve(psi0.reshape((1, 3, 16, 16, 16)), data, 1, algorithm="fused", **KW)
    assert capsys.readouterr().out.count(LINE.format(3)) == 1
    rl.deconvolve(psi0[0], data, 1, algorithm="fused", **KW)
    rl.deconvolve(psi0, data, 1, algorithm="fft", **KW)
    assert "on fused" not in capsys.readouterr().out
    assert calls == ["fused", "fused", "fused", "fft"]


def test_batch_axes_of_views_must_be_psis():
    """Per-entry views whose batch axes are not psi's are refused, even
    where their sizes multiply to the same count."""
    psi0, data = _data((16,) * 3, 4, "cpu")
    views = data.views.unsqueeze(1).expand((V, 4) + data.views.shape[1:]).contiguous()
    bad = MultiViewData(views, data.kernel1, data.kernel2, data.weights)
    with pytest.raises(ValueError, match=r"need B = \(2, 2\)"):
        rl.deconvolve(psi0.reshape((2, 2, 16, 16, 16)), bad, 1, algorithm="fused", **KW)


# The memory an NVIDIA H100 80GB HBM3 reports as its total through
# torch.cuda.mem_get_info, which deconvolve_auto reads for its cap.
H100_BYTES = 85_017_493_504


def test_ladder_keeps_a_fused_batch_in_core_where_it_fits(monkeypatch, capsys):
    """15 volumes of 512³, 4 views, shared per-voxel weights, on the H100
    (meta tensors, the CUDA rule): one volume of 512³ takes fused, so the
    batch does.  Counted one entry at a time it needs 60 volumes (views 4,
    weights 4, the split spectrum pairs 16, one entry's 8 and 2 for each of
    the 14 others), 32.2 GB, and runs in core; counted at 8 volumes an
    entry, 144 volumes (77.3 GB) would pass the cap of 76.5 GB and raise,
    where the fft batch (136 volumes, 73.0 GB) fits."""
    cuda = torch.device("cuda")
    shape, nb, views = (512,) * 3, 15, 4
    vol = 4 * 512**3
    meta = dict(device="meta", dtype=torch.float32)
    stack, kernels = torch.empty((views,) + shape, **meta), torch.empty((views, 9, 9, 9), **meta)
    data = MultiViewData(stack, kernels, kernels, stack)
    assert rl.resolve_algorithm("auto", shape, cuda) == "fused"
    est = dispatch.estimate_workspace_bytes(data, "auto", cuda, batch=nb)
    assert est == (8 + 16 + 8 + 2 * (nb - 1)) * vol
    assert dispatch.estimate_workspace_bytes(data, "fft", cuda, batch=nb) == (8 + 8 + 8 * nb) * vol
    assert dispatch.estimate_workspace_bytes(data, "auto", cuda) == (8 + 16 + 8) * vol

    real = rl.resolve_algorithm
    monkeypatch.setattr(dispatch, "resolve_algorithm",
                        lambda a, s, device=None, chunk=False: real(a, s, cuda, chunk))
    monkeypatch.setattr(dispatch, "device_capacity_bytes", lambda device=None: H100_BYTES)
    ran = []
    monkeypatch.setattr(dispatch, "deconvolve", lambda psi, *a, **k: ran.append(k) or psi)
    monkeypatch.setenv("LMVN_TRACE", "1")
    psi0 = torch.empty((nb,) + shape, **meta)
    assert dispatch.deconvolve_auto(psi0, data, 1, device="meta", **KW) is not None
    assert len(ran) == 1 and ran[0]["algorithm"] == "auto"
    assert f"in-core on one device (est {est >> 20} MiB" in capsys.readouterr().out


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("shape,via", [((64,) * 3, "fused"), ((256,) * 3, "auto")],
                         ids=["64-fused", "256-deconvolve_auto"])
def test_card_each_entry_is_its_single_fused_call(cuda, monkeypatch, capsys, shape, via):
    """A batch of 2 with shared views and per-voxel weights, 10 iterations:
    each entry bitwise the single fused call on it, and the trace line
    names fused once, for the batch alone.  Through ``deconvolve_auto`` the single
    calls are ``deconvolve_auto``'s too, and both take fused."""
    monkeypatch.delenv("LMVN_FUSED_SPEC_BF16", raising=False)
    monkeypatch.delenv("LMVN_FUSED_CARRY", raising=False)
    monkeypatch.setenv("LMVN_TRACE", "1")
    psi0, data = _data(shape, 2, cuda, views=4)
    if via == "fused":
        run = lambda p: rl.deconvolve(p, data, 10, algorithm="fused", **KW)
    else:
        assert rl.resolve_algorithm("auto", shape, cuda) == "fused"
        run = lambda p: dispatch.deconvolve_auto(p, data, 10, device=cuda, **KW)
    got = run(psi0)
    torch.cuda.synchronize(cuda)
    assert capsys.readouterr().out.count(LINE.format(2)) == 1
    for b in range(2):
        one = run(psi0[b])
        assert torch.equal(got[b], one), b
    assert "on fused" not in capsys.readouterr().out
    assert bool(torch.isfinite(got).all())
