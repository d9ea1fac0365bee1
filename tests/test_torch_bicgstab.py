"""The port's BiCGStab family against the JAX reference.

The same numpy operators and right-hand sides (seeded) go to both
packages: ``convection_diffusion(400)``, the nonsymmetric template of
tests/test_bicgstab.py, and the 5-band ``laplacian_2d(16, 16)``.  The
port's ``engine="fused"`` runs the sweep's plain version here.  The JAX
fused path reaches a Pallas kernel that does not run under this JAX
(ROADMAP.md queue 3, H1), so the port's fused path is held against the
reference's ``engine="naive"`` and against the reference's own fused
driver with ``ref.pipebicgstab_fused_ref`` in place of the kernel.

Tolerances: residual histories to rtol 1e-10 above a 1e-10 relative
floor, ``iters`` exactly, x to 1e-10 of its largest entry.  BiCGStab
carries a rounding-order difference forward faster than CG: classical
BiCGStab stays inside 1e-10 for 40 iterations on convection_diffusion(400),
the pipelined recurrence (whose Gram polynomials cancel) for about 20, by
which point the residual has fallen by 1e-4 (ROADMAP.md queue 3, H6), so
the pipelined histories are compared over 20 iterations (15 on the 2-D
Laplacian, which converges slower; 12 with a residual replacement at the
10th, whose ``b - A x`` cancels) and the classical ones over 40.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.krylov as jk
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core.krylov import (SolverOptions, bicgstab,
                                     pbicgstab_scalars, pipebicgstab)
from repro_torch.core.krylov.engine import FusedEngine
from repro_torch.core.krylov.operators import MatFreeOperator
from repro_torch.kernels import ops

jbicg = importlib.import_module("repro.core.krylov.bicgstab")

PIPE_ITERS = {"cd": 20, "lap2d": 15}


def _pair(A):
    return A, convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                     grid_shape=A.grid_shape, device="cpu")


@pytest.fixture(scope="module", params=["cd", "lap2d"])
def system(request):
    A = {"cd": jk.convection_diffusion(400),
         "lap2d": jk.laplacian_2d(16, 16)}[request.param]
    b = np.random.default_rng(0).standard_normal(A.n)
    return (request.param,) + _pair(A) + (b,)


@pytest.fixture(scope="module")
def cd():
    A, T = _pair(jk.convection_diffusion(400))
    return A, T, np.random.default_rng(0).standard_normal(400)


def _t(v):
    return torch.from_numpy(np.array(v))


def _hist_close(want, got, rtol=1e-10, floor_rel=1e-10):
    hw = np.asarray(want)
    hg = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert hw.shape == hg.shape
    mask = hw > floor_rel * max(hw.max(), 1.0)
    assert mask.sum() > 0
    np.testing.assert_allclose(hg[mask], hw[mask], rtol=rtol)


def _x_close(want, got):
    xw = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())


def _jopts(**kw):
    return jk.SolverOptions(**kw)


# -- classical BiCGStab --------------------------------------------------------

@pytest.mark.parametrize("engine", [None, "naive", "fused"])
@pytest.mark.parametrize("jacobi", [False, True])
def test_bicgstab_matches_reference(cd, engine, jacobi):
    """Jacobi by name on the engines; the inline path takes callables only
    (in both packages), so it gets diag^-1 as one."""
    A, T, b = cd
    jM = tM = "jacobi" if jacobi else None
    if jacobi and engine is None:
        invd = 1.0 / np.asarray(A.diagonal())
        jM = lambda z, d=jnp.asarray(invd): d * z  # noqa: E731
        tM = lambda z, d=_t(invd): d * z  # noqa: E731
    want = jk.bicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=40, M=jM, engine=None if engine is None else "naive"))
    got = bicgstab(T, _t(b), options=SolverOptions(maxiter=40, M=tM,
                                                   engine=engine))
    _hist_close(want.res_history, got.res_history)
    _x_close(want.x, got.x)
    assert int(got.iters) == int(want.iters) == 40


def test_bicgstab_history_frozen_after_convergence(cd):
    A, T, b = cd
    want = jk.bicgstab(A, jnp.asarray(b), maxiter=120, tol=1e-8)
    got = bicgstab(T, _t(b), options=SolverOptions(maxiter=120, tol=1e-8))
    it = int(got.iters)
    assert it == int(want.iters) < 110
    tail = got.res_history[it + 1:]
    assert tail.numel() > 5 and bool((tail == tail[0]).all())
    assert float(tail[0]) == float(got.res_norm)


# -- pipelined BiCGStab --------------------------------------------------------

@pytest.mark.parametrize("engine", [None, "naive", "fused"])
@pytest.mark.parametrize("M", [None, "jacobi"])
def test_pipebicgstab_matches_reference(system, engine, M):
    """None against the reference's inline path, naive and fused against
    its naive engine."""
    name, A, T, b = system
    it = PIPE_ITERS[name]
    want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=it, M=M, engine=None if engine is None else "naive"))
    got = pipebicgstab(T, _t(b), options=SolverOptions(maxiter=it, M=M,
                                                       engine=engine))
    _hist_close(want.res_history, got.res_history)
    _x_close(want.x, got.x)
    assert int(got.iters) == int(want.iters)
    assert (got.detect_history is not None) == (engine == "fused")
    assert ops.launch_counts()["pipebicgstab_fused"] == 0   # plain on CPU


def test_fused_matches_reference_driver_with_oracle(system, monkeypatch):
    """The reference's own fused driver, its kernel replaced by
    ``ref.pipebicgstab_fused_ref``: same history, x and checksum row."""
    from repro.kernels import ops as jops
    monkeypatch.setattr(
        jops, "pipebicgstab_fused_step",
        lambda offsets, bands, *args, **kw: ref.pipebicgstab_fused_ref(
            offsets, bands, *args))
    name, A, T, b = system
    it = PIPE_ITERS[name]
    for M in (None, "jacobi"):
        want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
            maxiter=it, M=M, engine="fused"))
        got = pipebicgstab(T, _t(b), options=SolverOptions(
            maxiter=it, M=M, engine="fused"))
        _hist_close(want.res_history, got.res_history)
        _x_close(want.x, got.x)
        dw = np.asarray(want.detect_history)
        assert got.detect_history.shape == dw.shape == (it,)
        # the checksum residual is a rounding-level difference of sums
        assert np.abs(dw).max() < 1e-11
        assert float(got.detect_history.abs().max()) < 1e-11


def test_fused_equals_naive_and_launches_nothing_on_cpu(cd):
    _, T, b = cd
    before = ops.launch_counts()
    fused = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=30, engine="fused", M="jacobi"))
    naive = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=30, engine="naive", M="jacobi"))
    _hist_close(naive.res_history, fused.res_history, rtol=1e-12)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("engine", [None, "naive", "fused"])
def test_pipebicgstab_callable_M(cd, engine):
    A, T, b = cd
    invd = 1.0 / np.asarray(A.diagonal())
    jinvd, tinvd = jnp.asarray(invd), _t(invd)
    want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=20, M=lambda z: jinvd * z,
        engine=None if engine is None else "naive"))
    got = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=20, M=lambda z: tinvd * z, engine=engine))
    _hist_close(want.res_history, got.res_history)
    _x_close(want.x, got.x)
    assert got.detect_history is None


def test_callable_M_routes_spmv_through_fused_engine(cd, monkeypatch):
    """A callable M cannot run the sweep, but its operator applications
    go through the engine's SpMV (the kernel on the card)."""
    _, T, b = cd
    calls = []
    orig = FusedEngine.spmv
    monkeypatch.setattr(FusedEngine, "spmv", lambda self, A_, v: (
        calls.append(1), orig(self, A_, v))[1])
    pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=10, M=lambda z: 0.5 * z, engine="fused"))
    assert len(calls) == 3 + 2 * 10   # init r0, w0, t0 + two per iteration
    calls.clear()
    pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=10, M="jacobi", engine="fused"))
    assert calls == []                 # the sweep path never calls it


@pytest.mark.parametrize("engine", ["naive", "fused"])
def test_pipebicgstab_rr_matches_reference(cd, engine):
    """Residual replacement every 10 iterations: the history over the
    first 12 (one replacement inside) against the reference, and after 80
    the recurrence residual pinned to the true one."""
    A, T, b = cd
    want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=12, rr=10, engine="naive"))
    got = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=12, rr=10, engine=engine))
    plain = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=12, engine=engine))
    assert not torch.equal(got.res_history, plain.res_history)
    _hist_close(want.res_history, got.res_history)
    long = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=80, rr=10, engine=engine))
    true_res = float(torch.linalg.norm(_t(b) - T.matvec(long.x)))
    assert abs(true_res - float(long.res_norm)) < 1e-10


def test_pipebicgstab_rr_tau_matches_reference(cd):
    A, T, b = cd
    tau = 1.0
    want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=20, rr_tau=tau, engine="naive"))
    got = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=20, rr_tau=tau, engine="fused"))
    _hist_close(want.res_history, got.res_history)
    assert int(got.iters) == int(want.iters)


@pytest.mark.parametrize("M", [None, "jacobi"])
def test_forced_iterates_drift_like_the_reference(M):
    """ROADMAP.md H8, at the size chip_smoke.py's CPU rehearsal uses:
    convection_diffusion(65,536) converges to 1e-10 in about 60
    iterations; forced on to 400 with tol=0, the recurrence residual stays
    at rounding level (~5e-13, 2e-15 of ||b||) while the true residual of x
    drifts to ~2e-2 of ||b||, in the JAX package's naive path and the
    port's naive and fused paths alike.  A residual replacement every 50
    iterations pins both to rounding level."""
    n, iters = 65_536, 400
    A, T = _pair(jk.convection_diffusion(n))
    b = np.random.default_rng(0).standard_normal(n)
    nb = np.linalg.norm(b)

    def true_rel(x):
        ax = np.asarray(A.matvec(jnp.asarray(np.asarray(x))))
        return np.linalg.norm(b - ax) / nb

    for rr in (0, 50):
        runs = [jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
            maxiter=iters, M=M, rr=rr, engine="naive"))]
        runs += [pipebicgstab(T, _t(b), options=SolverOptions(
            maxiter=iters, M=M, rr=rr, engine=engine))
            for engine in ("naive", "fused")]
        recurrence = [float(r.res_norm) / nb for r in runs]
        true = [true_rel(r.x) for r in runs]
        assert max(recurrence) < 1e-13
        if rr:
            assert max(true) < 1e-13
        else:
            assert min(true) > 1e-3                  # x has drifted ...
            assert max(true) < 10 * min(true)        # ... to the same order


@pytest.mark.parametrize("engine", [None, "fused"])
def test_pipebicgstab_tol_freezes_like_reference(cd, engine):
    """Frozen AT the iterate that met tol: same iters, a constant tail
    equal to res_norm."""
    A, T, b = cd
    want = jk.pipebicgstab(A, jnp.asarray(b), options=_jopts(
        maxiter=60, tol=1e-3, engine=None if engine is None else "naive"))
    got = pipebicgstab(T, _t(b), options=SolverOptions(
        maxiter=60, tol=1e-3, engine=engine))
    it = int(got.iters)
    assert it == int(want.iters) < 20
    _hist_close(want.res_history, got.res_history)
    tail = got.res_history[it:]
    assert bool((tail == tail[0]).all())
    assert float(tail[0]) == float(got.res_norm)
    assert float(got.res_norm) <= 1e-3 * np.linalg.norm(b) * 1.01
    if engine == "fused":
        assert bool((got.detect_history[it:]
                     == got.detect_history[it]).all())


def test_pbicgstab_scalars_match_reference():
    rng = np.random.default_rng(3)
    for first in (True, False):
        V = rng.standard_normal((6, 50))
        G = V @ V.T
        prev = rng.uniform(0.5, 1.5, 3)
        want = jbicg.pbicgstab_scalars(jnp.asarray(G), *map(jnp.asarray, prev),
                                    jnp.asarray(first), 1e-300)
        got = pbicgstab_scalars(_t(G), *map(_t, prev), first, 1e-300)
        for w, g in zip(want, got):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-13)


def test_pipebicgstab_rejections(cd):
    """The reference's rejections (tests/test_bicgstab.py)."""
    _, T, b = cd
    bt = _t(b)
    with pytest.raises(ValueError, match="distributed_solve"):
        pipebicgstab(T, bt, options=SolverOptions(maxiter=5,
                                                  engine="sharded_fused"))
    with pytest.raises(ValueError, match="x0"):
        pipebicgstab(T, bt, torch.zeros_like(bt),
                     options=SolverOptions(maxiter=5, M=lambda z: z))
    with pytest.raises(ValueError, match="custom"):
        pipebicgstab(T, bt, dot=lambda u, v: (u * v).sum(),
                     options=SolverOptions(maxiter=5, engine="naive"))
    with pytest.raises(ValueError, match="rr_tau"):
        pipebicgstab(T, bt, gram_reduce=lambda G: G,
                     options=SolverOptions(maxiter=5, rr_tau=1.0))
    with pytest.raises(ValueError, match="DiaMatrix"):
        pipebicgstab(MatFreeOperator(fn=T.matvec, n=T.n), bt,
                     options=SolverOptions(maxiter=5, M="jacobi"))
    with pytest.raises(ValueError, match="linear callable"):
        pipebicgstab(T, bt, options=SolverOptions(maxiter=5, M="ilu"))
    with pytest.raises(ValueError, match="precision"):
        pipebicgstab(T, bt, options=SolverOptions(maxiter=5,
                                                  precision="bf16"))
    with pytest.raises(ValueError, match="custom"):
        bicgstab(T, bt, dot=lambda u, v: (u * v).sum(),
                 options=SolverOptions(maxiter=5, engine="naive"))
    with pytest.raises(ValueError, match="rr"):
        bicgstab(T, bt, options=SolverOptions(maxiter=5, rr=3))


def test_gram_reduce_keeps_one_reduction(cd):
    """With ``gram_reduce`` the Gram goes through one call per iteration
    (plus the initial one), and the solve is the local one."""
    _, T, b = cd
    calls = []

    def reduce(G):
        calls.append(G.shape)
        return G

    got = pipebicgstab(T, _t(b), gram_reduce=reduce,
                       options=SolverOptions(maxiter=12))
    want = pipebicgstab(T, _t(b), options=SolverOptions(maxiter=12))
    assert calls == [(6, 6)] * 13
    assert torch.equal(got.res_history, want.res_history)

