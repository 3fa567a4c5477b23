"""The port's public names and function signatures against the JAX package's.

Every name in JAX's ``__all__`` is in the port's; every public function or
class a JAX module defines (or, for a package, re-exports) is in the port's
module of the same path; and the parameters of every such function begin
with JAX's, in JAX's order, so a call passed by position binds as it does
in JAX.  What differs by decision is listed below with its reason.
Private names are outside the check: among them the jit-key machinery
(``_knob_fingerprint``, the ``_*_cache_size`` hooks), which the port, running
eagerly, does not have (ROADMAP).
"""

import importlib
import inspect
import pkgutil

import pytest
import torch

import libmultiviewnative_tpu as J
import libmultiviewnative_torch as T

torch.set_num_threads(1)

# Modules of the JAX package with no counterpart module, and why.
NOT_PORTED_MODULES = {
    # the Pallas kernels: ported as CUDA kernels, ops/csrc/ and ops/elementwise.py, ops/fused.py
    "ops.pallas", "ops.pallas.elementwise", "ops.pallas.fused_dft2",
}

# Public names of a JAX module the port leaves out by decision, and why.
NOT_PORTED_NAMES = {
    # record_function and NVTX ranges that nothing read (nsys does not run
    # on the card's machine), whose user scope also puts a twin range on the
    # device's timeline: the port marks its layers with utils.trace.span
    "utils.trace.annotate",
}

# Functions whose parameters differ from JAX's by decision.
SIGNATURE_DECISIONS = {
    # one process drives several cells: the halo functions take this
    # process's blocks by cell and the mesh, where JAX's take one shard
    # and an axis name inside shard_map; the fused one takes conj_k, and no
    # interpret/precision/fold_x (no interpret mode, fp32 only, no fold-x)
    "parallel.halo.halo_exchange_z",
    "parallel.halo.convolve_zblock",
    "parallel.halo.convolve_zblock_dft",
    "parallel.halo.convolve_zblock_fused",
}


def _modules():
    out = []
    for m in pkgutil.walk_packages(J.__path__, "libmultiviewnative_tpu."):
        rel = m.name[len("libmultiviewnative_tpu."):]
        if rel in NOT_PORTED_MODULES or rel.startswith("ops.pallas."):
            continue
        out.append(rel)
    return sorted(out)


def _pair(rel):
    return (importlib.import_module(f"libmultiviewnative_tpu.{rel}"),
            importlib.import_module(f"libmultiviewnative_torch.{rel}"))


def _defined(mod, package: bool):
    """Public functions and classes ``mod`` defines; for a package, also
    those it re-exports."""
    names = set()
    for n, o in vars(mod).items():
        if n.startswith("_") or not (inspect.isfunction(o) or inspect.isclass(o)):
            continue
        where = getattr(o, "__module__", "") or ""
        if where == mod.__name__ or (package and where.startswith("libmultiviewnative_tpu")):
            names.add(n)
    return names


def test_top_level_all_matches_jax():
    assert set(J.__all__) <= set(T.__all__), sorted(set(J.__all__) - set(T.__all__))
    for n in T.__all__:
        assert hasattr(T, n), n


@pytest.mark.parametrize("rel", _modules())
def test_module_names_match_jax(rel):
    jm, tm = _pair(rel)
    package = hasattr(jm, "__path__")
    left_out = {n for n in _defined(jm, package) if f"{rel}.{n}" in NOT_PORTED_NAMES}
    assert not left_out & set(dir(tm)), f"{sorted(left_out)} ported now: take them off the list"
    missing = _defined(jm, package) - set(dir(tm)) - left_out
    assert not missing, sorted(missing)


def _functions(rel):
    jm, tm = _pair(rel)
    for n, o in sorted(vars(jm).items()):
        if n.startswith("_") or not inspect.isfunction(o) or o.__module__ != jm.__name__:
            continue
        if f"{rel}.{n}" in NOT_PORTED_NAMES:
            continue
        yield f"{rel}.{n}", o, getattr(tm, n)


SIGNED = [(name, j, t) for rel in _modules() for name, j, t in _functions(rel)]


@pytest.mark.parametrize("name, jfn, tfn", SIGNED, ids=[s[0] for s in SIGNED])
def test_parameters_begin_with_jax(name, jfn, tfn):
    jp = list(inspect.signature(jfn).parameters.values())
    tp = list(inspect.signature(tfn).parameters.values())
    same = [p.name for p in tp[:len(jp)]] == [p.name for p in jp]
    if name in SIGNATURE_DECISIONS:
        assert not same, f"{name} now matches JAX: take it off the list"
        return
    assert same, ([p.name for p in jp], [p.name for p in tp])
    for a, b in zip(jp, tp):
        if a.default is inspect.Parameter.empty or callable(a.default):
            continue
        if type(a.default).__name__ == "PartitionSpec":  # JAX's P('view', 'z', None, None)
            assert tuple(x for x in a.default if x) == tuple(b.default), name
            continue
        assert a.default == b.default, (name, a.name, a.default, b.default)


def test_f7_names():
    """The names ROADMAP queue 3's F7 listed as missing."""
    from libmultiviewnative_torch.core import convolve, fft
    from libmultiviewnative_torch.deconv import rl
    from libmultiviewnative_torch.native_client import build_native
    from libmultiviewnative_torch.reference import oracle

    assert isinstance(fft.default_spectrum_cache, fft.KernelSpectrumCache)
    assert convolve.crop_at_offsets is T.crop_at_offsets
    assert convolve.embed_at_offsets is T.embed_at_offsets
    assert inspect.signature(rl.deconvolve_jit).parameters["algorithm"].default == "fft"
    assert "force" in inspect.signature(build_native).parameters
    assert callable(oracle.direct_convolve) and callable(oracle.l1norm)


@pytest.mark.parametrize("boundary", ["zero", "wrap"])
def test_direct_convolve_oracle_matches_jax(boundary):
    import numpy as np
    from libmultiviewnative_tpu.reference import oracle as joracle
    from libmultiviewnative_torch.reference import oracle

    rng = np.random.default_rng(4)
    img = rng.normal(size=(6, 5, 7))
    k = rng.normal(size=(3, 4, 3))
    np.testing.assert_array_equal(oracle.direct_convolve(img, k, boundary),
                                  joracle.direct_convolve(img, k, boundary))
    assert oracle.l1norm(img, img + 0.5) == joracle.l1norm(img, img + 0.5)
    with pytest.raises(ValueError, match="unknown boundary"):
        oracle.direct_convolve(img, k, "mirror")


def test_update_fn_reaches_the_view_steps():
    """F8: rl_view_step* take JAX's ``update_fn`` (the fused one ignores it,
    as JAX's does: the update runs inside its last pass)."""
    import numpy as np
    from libmultiviewnative_torch.deconv import rl
    from libmultiviewnative_torch.ops.elementwise import rl_update

    rng = np.random.default_rng(2)
    psi, view = (torch.from_numpy(rng.gamma(2.0, 5.0, (8, 8, 8)).astype(np.float32))
                 for _ in range(2))
    k = torch.from_numpy(rng.random((3, 3, 3)).astype(np.float32))
    kh = rl.prepare_spectra(k[None], (8, 8, 8))[0]
    seen = []

    def update(p, integral, w, lam, mv):
        seen.append(1)
        return rl_update(p, integral, w, lam, mv)

    want = rl.rl_view_step(psi, view, kh, kh, 0.5, 0.0, 1e-4)
    got = rl.rl_view_step(psi, view, kh, kh, 0.5, 0.0, 1e-4, update)
    assert seen and torch.equal(got, want)
    out = torch.empty_like(psi)
    assert rl.rl_view_step(psi, view, kh, kh, 0.5, 0.0, 1e-4, update, out=out) is out
    assert torch.equal(out, want)
    assert rl._select_rl_update("pallas") is rl._select_rl_update("jnp") is rl_update
    with pytest.raises(ValueError, match="unknown elementwise"):
        rl._select_rl_update("mosaic")
