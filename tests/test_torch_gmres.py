"""The port's GMRES family against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and carried to both packages
(``convert.dia_from_numpy``).  What is held, and to what:

* ``spmv_dia_ext_plain`` against ``ref.spmv_dia_ref`` bit for bit, and
  ``NaiveEngine.dots`` against ``ref.fused_dots_ref``;
* ``gmres`` / ``pgmres`` with ``engine=None`` and ``engine="naive"``
  against the JAX package's same path: histories to rtol 1e-12, ``x``
  within 1e-10 of its largest entry (restart 5-40 on
  ``tridiagonal_laplacian(200 and 4096)`` and ``convection_diffusion``,
  with and without a Jacobi preconditioner);
* ``engine="fused"`` (the kernels' plain versions here) against the JAX
  naive path: histories to rtol 1e-10 while they stay above 1e-4 of their
  start (ROADMAP.md queue 3, H6), ``x`` as above.  The JAX fused engine
  reaches a Pallas kernel (H1) and is not the oracle;
* the breakdown case (``b`` an eigenvector of a diagonal operator, so
  ``h_{1,0} = 0`` exactly) through the SVD least squares;
* ``gmres_restarted`` with ``inner=pgmres`` and ``pgmres(depth=2)``'s
  route to ``pgmres_l``;
* the inline route on 2 and 4 gloo ranks (one spawn per world size with
  every case inside it): ``gmres`` and ``pgmres`` with ``use_kernel`` on
  and off, and ``pipecg`` with it on, against the JAX package's
  single-device inline solve (histories to 1e-10, ``x`` within 1e-10 of
  its largest entry), with their blocking all-reduces counted: PGMRES
  finishes line 18 with ONE all-reduce, so an iteration holds two.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.krylov as jk
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core.krylov import (SolverOptions, distributed_solve, gmres,
                                     gmres_restarted, jacobi_preconditioner,
                                     pgmres, pgmres_l, pipecg)
from repro_torch.core.krylov.engine import get_engine
from repro_torch.distributed import comm, ranks
from repro_torch.kernels import ops
from repro_torch.kernels.spmv_dia import spmv_dia_ext, spmv_dia_ext_plain

OPS = {"lap200": jk.tridiagonal_laplacian(200),
       "lap4096": jk.tridiagonal_laplacian(4096),
       "cd1000": jk.convection_diffusion(1000)}
SOLVERS = {"gmres": (gmres, jk.gmres), "pgmres": (pgmres, jk.pgmres)}
# (operator, restart, Jacobi?)
CASES = [("lap200", 40, False), ("lap4096", 5, False), ("lap4096", 40, True),
         ("cd1000", 20, False), ("cd1000", 40, True)]
IDS = [f"{op}-m{m}{'-jacobi' if jac else ''}" for op, m, jac in CASES]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _port(name):
    A = OPS[name]
    return convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                  device="cpu")


def _x_close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


def _hist_close(want, got, rtol=1e-12, floor_rel=0.0):
    hw, hg = np.asarray(want), np.asarray(got)
    assert hw.shape == hg.shape
    mask = hw > floor_rel * hw[0]
    assert mask.sum() > 0
    np.testing.assert_allclose(hg[mask], hw[mask], rtol=rtol)


def _solve_both(solver, name, restart, jacobi, engine, jax_engine):
    A, At = OPS[name], _port(name)
    b = _rhs(A.n)
    ours, theirs = SOLVERS[solver]
    jM = jk.jacobi_preconditioner(A) if jacobi else None
    tM = jacobi_preconditioner(At) if jacobi else None
    want = theirs(A, jnp.asarray(b), restart=restart, M=jM,
                  engine=jax_engine)
    got = ours(At, torch.from_numpy(b), restart=restart, M=tM,
               engine=engine)
    return got, want


# -- the extended-x entry and the naive engine's multi-dot -------------------

@pytest.mark.parametrize("offsets,halo,k", [
    ((-1, 0, 1), 1, 1), ((-1, 0, 1), 3, 1), ((-2, -1, 0, 1, 2), 2, 3),
    (tuple(range(-10, 11)), 10, 1)])
def test_spmv_dia_ext_plain_is_the_reference_oracle(offsets, halo, k):
    rng = np.random.default_rng(len(offsets) + halo)
    n = 300
    bands = rng.standard_normal((len(offsets), n))
    x_ext = rng.standard_normal((k, n + 2 * halo))
    got = spmv_dia_ext(offsets, torch.from_numpy(bands),
                       torch.from_numpy(x_ext if k > 1 else x_ext[0]), halo)
    for j in range(k):
        want = np.asarray(ref.spmv_dia_ref(offsets, jnp.asarray(bands),
                                           jnp.asarray(x_ext[j]), halo))
        row = got[j] if k > 1 else got
        np.testing.assert_array_equal(row.numpy(), want)
    assert torch.equal(got, spmv_dia_ext_plain(
        offsets, torch.from_numpy(bands),
        torch.from_numpy(x_ext if k > 1 else x_ext[0]), halo))


def test_spmv_dia_ext_is_counted_and_checks_its_operands():
    assert "spmv_dia_ext" in ops.launch_counts()
    ops.reset_launch_counts()
    bands = torch.ones((3, 8), dtype=torch.float64)
    ops.spmv_dia_ext_step((-1, 0, 1), bands, torch.ones(10), 1)
    assert ops.launch_counts()["spmv_dia_ext"] == 0   # the CPU runs plain
    with pytest.raises(ValueError, match="columns"):
        spmv_dia_ext((-1, 0, 1), bands, torch.ones(9), 1)
    with pytest.raises(ValueError, match="does not cover"):
        spmv_dia_ext((-2, 0, 2), bands, torch.ones(10), 1)


def test_naive_engine_dots_is_v_times_z():
    rng = np.random.default_rng(1)
    V, z = rng.standard_normal((41, 500)), rng.standard_normal(500)
    got = get_engine("naive").dots(torch.from_numpy(V), torch.from_numpy(z))
    want = np.asarray(ref.fused_dots_ref(jnp.asarray(V), jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    fused = get_engine("fused").dots(torch.from_numpy(V),
                                     torch.from_numpy(z))
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-12,
                               atol=1e-12)


# -- one device against the JAX package -------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("engine", [None, "naive"])
def test_matches_the_reference_path(solver, case, engine):
    name, restart, jacobi = case
    got, want = _solve_both(solver, name, restart, jacobi, engine, engine)
    assert tuple(got.res_history.shape) == (restart,)
    assert int(got.iters) == restart == int(want.iters)
    _hist_close(want.res_history, got.res_history.numpy())
    _x_close(got.x.numpy(), want.x)
    assert float(got.res_norm) == pytest.approx(float(want.res_norm),
                                                rel=1e-9)


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("engine", [None, "naive"])
def test_float32_follows_the_reference_float32_recurrence(solver, engine):
    """float32 operands: the Arnoldi loop and the Givens estimates stay in
    float32 as the reference's do; the two packages differ only by the
    summation order of their dots (rtol 1e-4 over 20 steps)."""
    A = OPS["cd1000"]
    bands = np.asarray(A.bands).astype(np.float32)
    b = _rhs(A.n).astype(np.float32)
    ours, theirs = SOLVERS[solver]
    want = theirs(jk.DiaMatrix(offsets=A.offsets, bands=jnp.asarray(bands)),
                  jnp.asarray(b), restart=20, engine=engine)
    got = ours(convert.dia_from_numpy(A.offsets, bands, device="cpu"),
               torch.from_numpy(b), restart=20, engine=engine)
    assert np.asarray(want.res_history).dtype == np.float32
    assert got.res_history.dtype == got.x.dtype == torch.float32
    _hist_close(want.res_history, got.res_history.numpy(), rtol=1e-4)
    _x_close(got.x.numpy(), want.x, rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_fused_engine_matches_the_reference_naive_path(solver, case):
    name, restart, jacobi = case
    ops.reset_launch_counts()
    got, want = _solve_both(solver, name, restart, jacobi, "fused", "naive")
    assert sum(ops.launch_counts().values()) == 0   # plain versions here
    _hist_close(want.res_history, got.res_history.numpy(), rtol=1e-10,
                floor_rel=1e-4)
    _x_close(got.x.numpy(), want.x)


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("engine", [None, "naive", "fused"])
def test_breakdown_takes_the_svd_least_squares(solver, engine):
    """b = e_3 of diag(1..n): h_{1,0} = 0 exactly, H is rank one, and the
    minimum-norm least squares gives x = e_3 / 4 as the reference does."""
    n, restart = 64, 6
    d = np.arange(1.0, n + 1.0)
    A = jk.DiaMatrix(offsets=(0,), bands=jnp.asarray(d[None]))
    At = convert.dia_from_numpy((0,), d[None], device="cpu")
    b = np.zeros(n)
    b[3] = 1.0
    ours, theirs = SOLVERS[solver]
    got = ours(At, torch.from_numpy(b), restart=restart, engine=engine)
    want = theirs(A, jnp.asarray(b), restart=restart,
                  engine=None if engine is None else "naive")
    assert float(got.res_history[0]) == 0.0
    assert torch.isfinite(got.x).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-15)
    np.testing.assert_allclose(got.x.numpy(), b / 4.0, atol=1e-15)
    assert float(got.res_norm) <= 1e-15


def test_restarted_pgmres_matches_restarted_gmres_and_the_reference():
    A, At = OPS["lap200"], _port("lap200")
    b = _rhs(200, seed=3)
    bt = torch.from_numpy(b)
    g = gmres_restarted(At, bt, restart=25, cycles=3)
    p = gmres_restarted(At, bt, restart=25, cycles=3, inner=pgmres)
    assert int(g.iters) == int(p.iters) == 75
    assert tuple(p.res_history.shape) == (75,)
    np.testing.assert_allclose(g.x.numpy(), p.x.numpy(), rtol=1e-4,
                               atol=1e-6)
    want = jk.gmres_restarted(A, jnp.asarray(b), restart=25, cycles=3,
                              inner=jk.pgmres)
    _hist_close(want.res_history, p.res_history.numpy(), rtol=1e-10)
    _x_close(p.x.numpy(), want.x)
    # the tol test stops after the cycle that reaches it
    early = gmres_restarted(At, bt, restart=25, cycles=6, inner=pgmres,
                            tol=float(g.res_norm) / float(bt.norm()) * 1.01)
    assert int(early.iters) <= 75


def test_pgmres_depth_routes_to_pgmres_l():
    At = _port("lap200")
    b = torch.from_numpy(_rhs(200))
    via = pgmres(At, b, restart=20, depth=2)
    direct = pgmres_l(At, b, restart=20, l=2)
    assert torch.equal(via.res_history, direct.res_history)
    assert torch.equal(via.x, direct.x)
    with pytest.raises(ValueError, match="custom dot"):
        pgmres(At, b, restart=20, depth=2, dot=lambda u, v: (u * v).sum())


def test_one_cycle_refuses_maxiter_and_custom_dots_on_an_engine():
    At = _port("lap200")
    b = torch.from_numpy(_rhs(200))
    for solver in (gmres, pgmres):
        with pytest.raises(ValueError, match="restart="):
            solver(At, b, options=SolverOptions(maxiter=5))
        with pytest.raises(ValueError, match="custom dot"):
            solver(At, b, engine="naive", dot=lambda u, v: (u * v).sum())
    with pytest.raises(ValueError, match="depth"):
        gmres(At, b, options=SolverOptions(depth=2))
    with pytest.raises(ValueError, match="dots_reduce"):
        pgmres(At, b, engine="naive", dots_reduce=lambda v: v)
    # inline: a custom dot without dots_reduce would split line 18's batch
    with pytest.raises(ValueError, match="dots_reduce"):
        pgmres(At, b, dot=lambda u, v: (u * v).sum())


# -- the inline route on gloo ranks -------------------------------------------

RESTART = 20
# name: (solver, distributed_solve kwargs)
RANK_CASES = {
    "gmres": ("gmres", dict(restart=RESTART)),
    "gmres-kernel": ("gmres", dict(restart=RESTART, use_kernel=True)),
    "pgmres": ("pgmres", dict(restart=RESTART)),
    "pgmres-kernel": ("pgmres", dict(restart=RESTART, use_kernel=True)),
    "pipecg-kernel": ("pipecg", dict(maxiter=60, use_kernel=True)),
}
RANK_NAMES = list(RANK_CASES)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def rank_runs(request):
    At = _port("lap4096")
    b = torch.from_numpy(_rhs(4096))
    cases = [dict(solver=sv, A=At, b=b, kw=kw)
             for sv, kw in RANK_CASES.values()]
    return ranks.run(ranks.solve_cases, request.param, cases, "cpu",
                     device="cpu")


def _rank_reference(name):
    solver, kw = RANK_CASES[name]
    A, b = OPS["lap4096"], jnp.asarray(_rhs(4096))
    kw = {k: v for k, v in kw.items() if k != "use_kernel"}
    return getattr(jk, solver)(A, b, **kw)


@pytest.mark.parametrize("name", RANK_NAMES)
def test_inline_route_matches_the_reference(rank_runs, name):
    i = RANK_NAMES.index(name)
    want = _rank_reference(name)
    for outcome in rank_runs:
        got = outcome[i]
        np.testing.assert_array_equal(got["res_history"],
                                      rank_runs[0][i]["res_history"])
        _hist_close(want.res_history, got["res_history"], rtol=1e-10,
                    floor_rel=1e-10)
        _x_close(got["x"], want.x)
        assert got["launches"]["spmv_dia_ext"] == 0   # plain on the CPU


@pytest.mark.parametrize("solver", ["gmres", "pgmres"])
def test_use_kernel_takes_the_same_arithmetic(rank_runs, solver):
    plain = rank_runs[0][RANK_NAMES.index(solver)]
    kernel = rank_runs[0][RANK_NAMES.index(f"{solver}-kernel")]
    np.testing.assert_array_equal(plain["res_history"],
                                  kernel["res_history"])
    np.testing.assert_array_equal(plain["x"], kernel["x"])


def test_inline_reductions_per_iteration(rank_runs):
    """PGMRES: one all-reduce for ||r0||, then two an iteration over its
    m + 2 iterations (line 16's norm, line 18's batch) and one for the
    final residual.  GMRES (MGS): i + 1 dots and one norm at step i."""
    m = RESTART
    for outcome in rank_runs:
        for name in ("pgmres", "pgmres-kernel"):
            assert outcome[RANK_NAMES.index(name)]["all_reduces"] \
                == 2 * (m + 2) + 2
        for name in ("gmres", "gmres-kernel"):
            assert outcome[RANK_NAMES.index(name)]["all_reduces"] \
                == m * (m + 1) // 2 + m + 2


def test_one_rank_inline_gmres_in_process(tmp_path):
    """A one-rank group: the halo strips are zero and the all-reduce is
    the identity, so the route gives the local solve bit for bit."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        At = _port("lap200")
        b = torch.from_numpy(_rhs(200))
        local = pgmres(At, b, restart=15)
        comm.all_reduce.calls = 0
        for use_kernel in (False, True):
            got = distributed_solve(pgmres, At, b, restart=15,
                                    use_kernel=use_kernel)
            assert torch.equal(got.res_history, local.res_history)
            assert torch.equal(got.x, local.x)
        assert comm.all_reduce.calls == 2 * (2 * 17 + 2)
        got = distributed_solve(pipecg, At, b, maxiter=30, use_kernel=True)
        want = pipecg(At, b, options=SolverOptions(maxiter=30))
        assert torch.equal(got.res_history, want.res_history)
        # the route hands gmres only the knobs the caller set: tol= alone,
        # or a default options object, passes no maxiter it refuses
        want = gmres(At, b, restart=15)
        for kw in (dict(tol=1e-8), dict(options=SolverOptions())):
            got = distributed_solve(gmres, At, b, restart=15, **kw)
            assert torch.equal(got.res_history, want.res_history)
        with pytest.raises(ValueError, match="restart="):
            distributed_solve(gmres, At, b, restart=15, maxiter=30)
    finally:
        dist.destroy_process_group()
