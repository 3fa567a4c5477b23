"""The forwarding of a whole kernel stack (``ops/fused.py``
``kernel_stack_spectrum_fused``, what ``deconv/rl.py``'s
``prepare_spectra_fused`` runs once a kernel stack on every fused call).

On the CPU the stack is the plain chain of each view, stacked, so it is
bitwise ``torch.stack`` of the per-view ``kernel_spectrum_fused``; each
view is held against the JAX package's ``kernel_spectrum_fused`` (imported
inside that test alone).  The launches of the CUDA branch are held here with the kernel library replaced
by a recorder (the pattern of tests/test_torch_spec_bf16.py): one gather,
one K4 and one ``spectrum_zsparse`` a stack, whatever the number of views;
what the card computes is held by the tests marked ``card`` below, which
skip without an NVIDIA GPU, and by chip_smoke.py's phase 31.  On the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_forward_stack.py

(``--noconftest``: tests/conftest.py imports JAX, which that machine lacks;
this file imports it only inside the test that compares with it.)

The index arithmetic of ``lmvn_fused_spectrum_gather`` and the planes
``lmvn_fused_spectrum_zsparse`` skips are mirrored in numpy here, so that
the rules the CUDA source follows are held against ``wrap_kernel`` and the
einsum chain on the CPU.
"""

import numpy as np
import pytest
import torch

from libmultiviewnative_torch.deconv import rl
from libmultiviewnative_torch.deconv.workspace import MultiViewData
from libmultiviewnative_torch.ops import fused as fu
from libmultiviewnative_torch.ops import fused_plan as fp

SHAPE = (16, 24, 32)  # (Z, Y, X)
BF16, F32 = torch.bfloat16, torch.float32


def _stack(shape, seed=0, views=3):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.random((views,) + tuple(shape)).astype(np.float32))


def _storage(monkeypatch, spec):
    monkeypatch.setenv("LMVN_FUSED_SPEC_BF16", "1" if spec == BF16 else "0")
    assert fu.spec_dtype() == spec


# ---------------------------------------------------------------- the plain path


def _steps(got, want) -> float:
    """The largest |a - b| over the one-bf16-step allowance of
    tests/test_torch_spec_bf16.py, 2^-7·max(|a|, |b|) + 2e-6·max|b|."""
    a, b = (np.concatenate([np.asarray(t, np.float32).ravel() for t in p]) for p in (got, want))
    lim = 2.0**-7 * np.maximum(np.abs(a), np.abs(b)) + 2e-6 * np.abs(b).max()
    return float(np.max(np.abs(a - b) / lim))


def _rel_pair(got, want) -> float:
    """max|got - want| over max|want| of an (re, im) pair taken together, as
    tests/test_torch_fused.py measures the forwarding."""
    a, b = (np.concatenate([np.asarray(t, np.float64).ravel() for t in p]) for p in (got, want))
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("spec", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kshape", [(3, 5, 7), (5, 4, 6), (5, 29, 9), (3, 5, 37)],
                         ids=["kz3", "kz5-even", "fold-y", "fold-x"])
def test_stack_matches_jax(monkeypatch, spec, kshape):
    """Each view of the stack against the JAX package's
    kernel_spectrum_fused at precision "highest" (its z-sparse branch, in
    interpret mode), with tests/test_torch_fused.py's 1e-5 of max in f32 and
    tests/test_torch_spec_bf16.py's one bf16 step in bf16; the stack is also
    bitwise torch.stack of each view's kernel_spectrum_fused, in the storage
    dtype, contiguous (V, Kxp, Z, Y), and prepare_spectra_fused is the same
    function.  fold-y and fold-x: a kernel wider than the volume, which
    wrap_kernel folds."""
    import jax.numpy as jnp

    from libmultiviewnative_tpu.ops.pallas import fused_dft2 as fd

    _storage(monkeypatch, spec)
    ks = _stack(kshape, views=2)
    assert fu.sparse_prep_ok(kshape[0], SHAPE[0])
    got = fu.kernel_stack_spectrum_fused(ks, SHAPE)
    plan = fp.make_fused_plan(SHAPE)
    for v, k in enumerate(ks):
        want = fd.kernel_spectrum_fused(jnp.asarray(k.numpy()), SHAPE, precision="highest")
        mine = tuple(g[v].float().numpy() for g in got)
        if spec == F32:
            assert _rel_pair(mine, want) <= 1e-5
        else:
            assert _steps(mine, tuple(np.asarray(w, np.float32) for w in want)) <= 1.0
    want = [fu.kernel_spectrum_fused(k, SHAPE) for k in ks]
    for part, g in enumerate(got):
        assert g.dtype == spec and g.is_contiguous()
        assert tuple(g.shape) == (2, plan.kxp, SHAPE[0], SHAPE[1])
        assert torch.equal(g, torch.stack([w[part] for w in want]))
    for g, p in zip(got, rl.prepare_spectra_fused(ks, SHAPE)):
        assert torch.equal(g, p)


def test_dense_branch_stacks_the_views():
    """A kernel too deep for the z-sparse branch takes the dense one view by
    view, stacked."""
    ks = _stack((9, 5, 7))
    assert not fu.sparse_prep_ok(9, SHAPE[0])
    got = fu.kernel_stack_spectrum_fused(ks, SHAPE)
    for part, g in enumerate(got):
        assert torch.equal(g, torch.stack([fu._spectrum_dense(k, SHAPE)[part] for k in ks]))


def _gather_rule(k: np.ndarray, zs: int, Y: int, X: int) -> np.ndarray:
    """lmvn_fused_spectrum_gather's rule in numpy: plane v·Zs + s, column x,
    row y of the gathered buffer is the sum of kernel[v, i, j, l] with
    i = (s + kz/2) mod Zs, j ≡ y + ky/2 (mod Y), l ≡ x + kx/2 (mod X) inside
    the kernel, taken in float32 by j, then l; one tap copied where the
    stack fits the volume (z never folds: Zs >= kz), 0 where there is none."""
    V, kz, ky, kx = k.shape
    fold = ky > Y or kx > X
    out = np.zeros((V * zs, X, Y), np.float32)
    for v in range(V):
        for s in range(zs):
            i = (s + kz // 2) % zs
            if i >= kz:
                continue
            for x in range(X):
                l0 = (x + kx // 2) % X
                for y in range(Y):
                    j0 = (y + ky // 2) % Y
                    if l0 >= kx or j0 >= ky:
                        continue
                    acc = np.float32(0.0 if fold else -0.0)
                    for j in range(j0, ky, Y):
                        for ll in range(l0, kx, X):
                            acc = np.float32(acc + k[v, i, j, ll])
                    out[v * zs + s, x, y] = acc
    return out


@pytest.mark.parametrize("kshape,zs", [((3, 5, 7), 8), ((5, 4, 6), 8), ((9, 8, 3), 16),
                                       ((16, 24, 32), 16), ((1, 1, 1), 8), ((5, 29, 9), 8),
                                       ((3, 5, 37), 8), ((5, 40, 60), 8), ((3, 70, 90), 8)],
                         ids=["kz3", "kz5", "kz9", "full", "one", "fold-y", "fold-x",
                              "fold-2x2", "fold-3x3"])
def test_gather_rule_is_wrap_kernel(kshape, zs):
    """The gather's rule is _gathered_plain (wrap_kernel into (Zs, Y, X),
    transposed to (Zs, X, Y)) bit for bit where the kernel fits the volume,
    and where one alias block is added to another (fold-y, fold-x: a sum
    of two is the same in any order).  With more blocks a position's taps
    are summed in another order than torch's reduction takes in
    wrap_kernel (its order is its own: on the CPU it differs from block
    order at 2 x 2 blocks), so both are held within 1e-6 of max of the
    float64 fold (a float32 sum of n terms rounds by up to (n - 1)·2^-24 of
    their sum: 4.8e-7 at 3 x 3 blocks)."""
    Z, Y, X = SHAPE
    ks = _stack(kshape, seed=1, views=2)
    want = _gather_rule(ks.numpy(), zs, Y, X)
    got = fu._gathered_plain(ks, zs, Y, X)
    assert got.is_contiguous()
    blocks = -(-kshape[1] // Y) * -(-kshape[2] // X)
    if blocks <= 2:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        wide = fu._gathered_plain(ks.double(), zs, Y, X).numpy()
        scale = np.abs(wide).max()
        assert np.abs(want - wide).max() <= 1e-6 * scale
        assert np.abs(got.numpy() - wide).max() <= 1e-6 * scale


@pytest.mark.parametrize("kz", [3, 5, 8, 13])
def test_contraction_skips_only_zero_planes(kz):
    """lmvn_fused_spectrum_zsparse sums over the kz planes a wrapped kernel
    occupies, plane jj < kz - kz/2 at s = jj and the rest at s = jj + Zs - kz;
    the planes between are zero in pass A of the gathered buffer, so the
    sum over those planes is the plain version's sum over all Zs, here to
    float64 rounding; and the plain version of a stack is each view's, bit
    for bit."""
    Z, Y, X = 32, 24, 16
    zs = fu._ceil8(kz)
    ks = _stack((kz, 5, 7), seed=2, views=2)
    plan = fp.make_fused_plan((Z, Y, X))
    u = fu.pass_a(fu._gathered_plain(ks, zs, Y, X), fp.make_fused_plan((2 * zs, Y, X)))
    tr, ti = fu._sparse_table(Z, kz, *plan.split_z, "cpu")
    head = kz - kz // 2
    planes = [jj if jj < head else jj + zs - kz for jj in range(kz)]
    assert fu._occupied(kz) == planes
    packed = fu._packed_table(Z, kz, *plan.split_z, "cpu")
    assert tuple(packed.shape) == (Z, kz + kz % 2, 2) and not packed[:, kz:].any()
    assert torch.equal(packed[:, :kz, 0], tr[:, planes]) and torch.equal(packed[:, :kz, 1], ti[:, planes])
    skipped = sorted(set(range(zs)) - set(planes))
    ur, ui = (t.double().reshape(plan.kxp, 2, zs, Y) for t in u)
    for s in skipped:
        assert not ur[:, :, s].any() and not ui[:, :, s].any()
    T = tr.double()[:, planes] + 1j * ti.double()[:, planes]
    uc = (ur + 1j * ui)[:, :, planes]
    want = torch.einsum("ps,kvsm->vkpm", T, uc)
    got = fu.spectrum_zsparse_plain(*u, tr, ti, 2)
    scale = float(want.abs().max())
    assert float((got[0].double() - want.real).abs().max()) <= 1e-6 * scale
    assert float((got[1].double() - want.imag).abs().max()) <= 1e-6 * scale
    one = [fu.spectrum_zsparse_plain(u[0][:, v * zs:(v + 1) * zs], u[1][:, v * zs:(v + 1) * zs],
                                     tr, ti, 1) for v in range(2)]
    for part in range(2):
        assert torch.equal(got[part], torch.cat([o[part] for o in one]))
    assert all(torch.equal(a, b) for a, b in zip(got, fu.spectrum_zsparse(*u, 2, kz, plan)))


def test_cpu_path_counts_no_launch():
    fu.reset_launches()
    fu.kernel_stack_spectrum_fused(_stack((5, 5, 5)), SHAPE)
    assert set(fu.launches.values()) == {0}


@pytest.mark.parametrize("kshapes", [[(5, 5, 5)] * 3, [(5, 5, 5), (3, 7, 5), (5, 5, 5)]],
                         ids=["one-shape", "two-shapes"])
def test_interleaved_forwards_each_stack_once(monkeypatch, kshapes):
    """The interleaved rung's fused spectra (the engine table's forwarding
    one operand a view): one forwarding of each kernel stack (of the views
    whose kernels share a shape), each view's spectrum bitwise its own
    kernel_spectrum_fused."""
    from libmultiviewnative_torch.deconv import engines

    calls = []

    def spy(kernels, shape):
        calls.append(tuple(kernels.shape))
        return fu.kernel_stack_spectrum_fused(kernels, shape)

    monkeypatch.setattr(engines, "kernel_stack_spectrum_fused", spy)
    g = np.random.default_rng(4)
    k1 = [g.random(k).astype(np.float32) for k in kshapes]
    k2 = [np.flip(k).copy() for k in k1]
    t1, t2 = ([torch.from_numpy(k) for k in ks] for ks in (k1, k2))
    ops1, ops2, _ = engines.forward("fused", t1, t2, SHAPE, "cpu", per_view=True)
    stacks = [(kshapes.count(k),) + k for k in dict.fromkeys(kshapes)]
    assert calls == stacks * 2  # kernel1's stacks, then kernel2's
    for ops, ks in ((ops1, k1), (ops2, k2)):
        for op, k in zip(ops, ks, strict=True):
            own = fu.kernel_spectrum_fused(torch.from_numpy(k), SHAPE)
            assert all(torch.equal(a, b) for a, b in zip(op, own))


# ---------------------------------------------------------------- the engine table
# deconv/engines.py forwards every engine's kernels, as a stack for the
# in-core rung and one operand a kernel for the off-core rungs, and counts
# the storage the ladder's estimates read


def _f32_volumes(op, shape) -> float:
    """The float32 volumes of ``shape`` an operand's tensors hold."""
    tensors = op if isinstance(op, (tuple, list)) else (op,)
    return sum(t.numel() * t.element_size() for t in tensors) / 4 / float(np.prod(shape))


@pytest.mark.parametrize("engine,shape", [("fft", SHAPE), ("dft", SHAPE), ("dft", (8, 8, 264)),
                                          ("fused", SHAPE), ("direct", SHAPE)], ids=str)
def test_table_counts_the_operands_it_forwards(engine, shape):
    """``spectrum_volumes`` against the operands ``forward`` makes, in f32
    volumes a view: a half-spectrum about 1, a full pair 2, a kernel 0, and
    the fused pair, counted 2 as the JAX package counts it, 2 (X/2 + 8) / X
    (1.5 at X = 32).  Under the adjoint, what kernel2's operand adds
    is at most what the count adds for it, and on dft exactly it (the
    negated imaginary part)."""
    from libmultiviewnative_torch.deconv import engines

    V = 2
    k1, k2 = _stack((5, 5, 3), views=V), _stack((3, 5, 5), seed=1, views=V)
    op1, op2, conj = engines.forward(engine, k1, k2, shape, "cpu")
    got = (_f32_volumes(op1, shape) + _f32_volumes(op2, shape)) / V
    count = engines.spectrum_volumes(engine, shape)
    assert not conj and got <= count + 0.5
    kernel_pair = 2 * (2 * (shape[2] / 2 + 8) / shape[2])  # kernel1's and kernel2's
    assert round(got) == count if engine != "fused" else got == kernel_pair
    a1, a2, conj = engines.forward(engine, k1, None, shape, "cpu", adjoint=True)
    assert conj == (engine in ("fft", "fused"))
    own = {t.data_ptr() for t in (a1 if isinstance(a1, tuple) else (a1,))}
    added = [t for t in (a2 if isinstance(a2, tuple) else (a2,)) if t.data_ptr() not in own]
    extra = round(_f32_volumes(tuple(added), shape) / V)
    counted = engines.spectrum_volumes(engine, shape, adjoint=True) - round(_f32_volumes(a1, shape) / V)
    assert extra <= counted and (engine != "dft" or extra == counted)


@pytest.mark.parametrize("engine", ["fft", "dft", "fused", "direct"])
def test_table_forwards_a_stack_as_its_kernels(engine):
    """Each view of a forwarded stack against its kernel forwarded alone:
    bitwise, but for dft, whose stack runs one batched product (1e-6 of
    max)."""
    from libmultiviewnative_torch.deconv import engines

    ks = _stack((5, 5, 3), views=3)
    stacked, _, _ = engines.forward(engine, ks, ks, SHAPE, "cpu")
    alone, _, _ = engines.forward(engine, list(ks), list(ks), SHAPE, "cpu", per_view=True)
    for v, op in enumerate(alone):
        parts = zip(op, stacked) if isinstance(op, tuple) else [(op, stacked)]
        for got, stack in parts:
            want = stack[v]
            if engine == "dft":
                assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
            else:
                assert torch.equal(got, want)


# ---------------------------------------------------------------- the CUDA branch
# The CUDA branch on CPU tensors, with the kernel library replaced by a
# recorder: which entries launch, with what, how often.  Nothing is computed.


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry

    def entries(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_card(monkeypatch):
    lib, plans = _Recorder(), []
    monkeypatch.setattr(fu._build, "library", lambda: lib)
    monkeypatch.setattr(fu, "_stream", lambda dev: None)
    monkeypatch.setattr(fu, "_device", lambda *ts: torch.device("cuda", 0))

    def plan_tensors(plan, dev):
        plans.append(tuple(plan.shape))
        c = fu.PlanTensors(plan, torch.device("cpu"))
        c.args = fu._PlanArgs()
        return c

    monkeypatch.setattr(fu, "plan_tensors", plan_tensors)
    fu.reset_launches()
    yield lib, plans
    fu.reset_launches()


@pytest.mark.parametrize("spec,suffix", [(F32, ""), (BF16, "_bf16")], ids=["f32", "bf16"])
@pytest.mark.parametrize("views", [1, 4])
def test_cuda_stack_is_four_launches(fake_card, monkeypatch, spec, suffix, views):
    """One gather, one K4 over the V·Zs gathered planes and one
    spectrum_zsparse a stack, whatever V; the contraction's _bf16 twin
    where u is bf16; the stacks (V, Kxp, Z, Y), contiguous, allocated once
    and handed to the kernel."""
    lib, plans = fake_card
    _storage(monkeypatch, spec)
    Z, Y, X = SHAPE
    ks = _stack((5, 4, 6), views=views)
    out = fu.kernel_stack_spectrum_fused(ks, SHAPE)
    assert lib.entries() == ["lmvn_fused_spectrum_gather", f"lmvn_fused_pass_a{suffix}",
                             f"lmvn_fused_spectrum_zsparse{suffix}"]
    assert plans == [(views * 8, Y, X)]
    (_, gather), _, (_, zsparse) = lib.calls
    assert gather[3:10] == (views, 5, 4, 6, 8, X, Y)
    plan = fp.make_fused_plan(SHAPE)
    assert zsparse[6:13] == (views, plan.kxh, plan.kxp, Z, Y, 8, 5)
    for t in out:
        assert t.dtype == spec and t.is_contiguous()
        assert tuple(t.shape) == (views, plan.kxp, Z, Y)
    assert {t.data_ptr() for t in out} == set(zsparse[1:3])
    assert fu.launches == {**{k: 0 for k in fu.launches}, "spectrum_gather": 1,
                           f"pass_a{suffix}": 1, f"spectrum_zsparse{suffix}": 1}


def test_cuda_folding_kernel_is_gathered(fake_card):
    """A kernel wider than the volume goes through the same three launches:
    the gather folds it."""
    lib, _ = fake_card
    Z, Y, X = SHAPE
    fu.kernel_stack_spectrum_fused(_stack((5, 29, 37)), SHAPE)
    assert lib.entries() == ["lmvn_fused_spectrum_gather", "lmvn_fused_pass_a",
                             "lmvn_fused_spectrum_zsparse"]
    assert lib.calls[0][1][3:10] == (3, 5, 29, 37, 8, X, Y)
    assert fu.launches["spectrum_gather"] == 1


@pytest.mark.parametrize("shape", [(16, 20, 32), (16, 24, 36), (20, 24, 32)], ids=str)
def test_cuda_refuses_an_unserved_shape(fake_card, shape):
    """A volume the fused engine does not serve (an axis not a multiple of
    8) raises before any launch: the gather's rows assume whole 16-byte
    stores."""
    lib, _ = fake_card
    with pytest.raises(ValueError):
        fu.kernel_stack_spectrum_fused(_stack((3, 5, 5)), shape)
    assert lib.calls == []


def test_cuda_dense_branch_launches_per_view(fake_card):
    """The dense branch is unchanged: K4 and K5 once a view."""
    lib, _ = fake_card
    fu.kernel_stack_spectrum_fused(_stack((9, 5, 7), views=3), SHAPE)
    assert lib.entries() == ["lmvn_fused_pass_a", "lmvn_fused_pass_bf"] * 3
    assert fu.launches["spectrum_zsparse"] == 0


@pytest.mark.parametrize("adjoint,stacks", [(False, 2), (True, 1)])
def test_cuda_call_counts_a_contraction_a_stack(fake_card, adjoint, stacks):
    """The counter the forwarding adds: once a kernel stack, so 2 a call
    (kernel1 and kernel2), 1 under the adjoint (kernel2 is kernel1's
    conjugate, no second stack)."""
    lib, _ = fake_card
    Z, Y, X = SHAPE
    k1 = _stack((5, 5, 5), views=4)
    data = MultiViewData(torch.ones((4, Z, Y, X)), k1, torch.flip(k1, (1, 2, 3)),
                         torch.full((4,), 0.25))
    rl._forward_spectra("fused", data, SHAPE, adjoint)
    assert fu.launches["spectrum_zsparse"] == stacks
    assert len(lib.calls) == 3 * stacks


def test_cuda_refuses_grad(fake_card):
    """A kernel stack that requires grad raises where the parent's per-view
    pass A raised: the CUDA launches write through raw pointers."""
    ks = _stack((5, 5, 5)).requires_grad_()
    with pytest.raises(NotImplementedError):
        fu.kernel_stack_spectrum_fused(ks, SHAPE)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def _bench_stack(V, kshape, dev, sigma0=2.0):
    """kernel1 of the benchmark's configurations: Gaussians of sigma
    sigma0 + 0.5 v, centred at k // 2."""
    axes = [torch.arange(s, dtype=torch.float64) - s // 2 for s in kshape]
    r2 = sum(a.reshape([-1 if i == d else 1 for i in range(3)]) ** 2 for d, a in enumerate(axes))
    ks = [torch.exp(-r2 / (2 * (sigma0 + 0.5 * v) ** 2)) for v in range(V)]
    return torch.stack([k / k.sum() for k in ks]).to(torch.float32).to(dev)


def _rel(got, want) -> float:
    """max|got - want| over max|want| of a (re, im) pair taken together: the
    imaginary part of a symmetric kernel's spectrum is rounding noise alone,
    so it has no scale of its own."""
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return err / max(float(b.double().abs().max()) for b in want)


@pytest.mark.card
@pytest.mark.parametrize("shape,kshape", [((256,) * 3, (21,) * 3), ((256,) * 3, (25,) * 3),
                                          ((512,) * 3, (21,) * 3), ((32, 24, 32), (5, 29, 37)),
                                          ((32, 24, 32), (3, 70, 90))],
                         ids=["256-k21", "256-k25", "512-k21", "fold-2", "fold-3x3"])
def test_card_stack_forwarding(cuda, monkeypatch, shape, kshape):
    """At the benchmark's shapes and with kernels wider than the volume: the
    gather bitwise _gathered_plain where at most two alias blocks meet
    (else within 1e-6 of max of the float64 fold, as the CPU holds the
    rule); the one K4 over V·Zs planes bitwise each view's own K4; the
    contraction within 1e-6 of max of its plain version in float64; the
    whole forwarding within 1e-6 of max of the einsum chain it replaces."""
    monkeypatch.delenv("LMVN_FUSED_SPEC_BF16", raising=False)
    V, (Z, Y, X) = 4, shape
    ks = _bench_stack(V, kshape, cuda)
    zs = fu._ceil8(kshape[0])
    g = fu._gathered(ks, zs, Y, X, cuda)
    if -(-kshape[1] // Y) * -(-kshape[2] // X) <= 2:
        assert torch.equal(g, fu._gathered_plain(ks, zs, Y, X))
    else:
        wide = fu._gathered_plain(ks.double(), zs, Y, X)
        assert float((g.double() - wide).abs().max()) <= 1e-6 * float(wide.abs().max())
    u = fu.pass_a(g, fp.make_fused_plan((V * zs, Y, X)))
    small = fp.make_fused_plan((zs, Y, X))
    for v in range(V):
        one = fu.pass_a(g[v * zs:(v + 1) * zs].contiguous(), small)
        assert all(torch.equal(a[:, v * zs:(v + 1) * zs], b) for a, b in zip(u, one))
    plan = fp.make_fused_plan(shape)
    tr, ti = fu._sparse_table(Z, kshape[0], *plan.split_z, str(cuda))
    got = fu.spectrum_zsparse(*u, V, kshape[0], plan)
    want = fu.spectrum_zsparse_plain(*(t.double() for t in (*u, tr, ti)), V, torch.float64)
    assert _rel(got, want) <= 1e-6
    del want
    chain = fu._stacked([fu._spectrum_sparse(k, shape) for k in ks])
    assert _rel(fu.kernel_stack_spectrum_fused(ks, shape), chain) <= 1e-6


@pytest.mark.card
def test_card_bf16_twin(cuda, monkeypatch):
    """The _bf16 twin on bf16 u is the f32 entry on the widened u rounded
    once to bf16, bit for bit; and the forwarding under bf16 storage is
    within one bf16 step of the einsum chain under bf16 storage (both round
    an f32 sum once, the sums taken in another order)."""
    V, n, kz = 4, 256, 21
    ks = _bench_stack(V, (kz,) * 3, cuda)
    zs = fu._ceil8(kz)
    u16 = tuple(t.to(BF16) for t in fu.pass_a(fu._gathered(ks, zs, n, n, cuda),
                                               fp.make_fused_plan((V * zs, n, n))))
    plan = fp.make_fused_plan((n,) * 3)
    twin = fu.spectrum_zsparse(*u16, V, kz, plan)
    widened = fu.spectrum_zsparse(*(t.float() for t in u16), V, kz, plan)
    assert all(t.dtype == BF16 for t in twin)
    assert all(torch.equal(a, b.to(BF16)) for a, b in zip(twin, widened))
    _storage(monkeypatch, BF16)
    got = fu.kernel_stack_spectrum_fused(ks, (n,) * 3)
    chain = fu._stacked([fu._spectrum_sparse(k, (n,) * 3) for k in ks])
    for a, b in zip(got, chain):
        assert a.dtype == b.dtype == BF16
        a, b = a.float(), b.float()
        step = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 2e-6 * float(b.abs().max())
        assert bool(((a - b).abs() <= step).all())
