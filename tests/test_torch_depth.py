"""The port's depth-l solvers (``pipecg_l``, ``pgmres_l``) against JAX's.

The same numpy inputs go to both packages; the JAX side always runs
``engine="naive"`` or the inline path (its fused chain reaches a Pallas
kernel that does not run under this JAX, ROADMAP.md queue 3, H1), and the
port's ``engine="fused"`` runs the ghost-chain kernel's plain version on
the CPU.

Tolerances.  Histories to rtol 1e-10 over the first 190 iterations of
``tridiagonal_laplacian(200)``: CG's residual collapses by ten orders in
its last iterations before n, where two correct summation orders part
(ROADMAP.md queue 3, H6); ``x`` to 1e-10 of its largest entry.  On the
21-band glen operator at l = 4 the basis conditions like kappa^4 and the
histories agree to 1e-8, the bound the reference holds its own fused
chain to against its naive one (tests/test_pipeline_depth.py).  The Cools
gate of the reference (tests/test_pipeline_depth.py): the depth-l history
within 1e-6 of CG's above 1e-8 of its largest entry, and l = 8 beyond it.
``pgmres_l`` solves its least squares through eigenvalue-clipped Gram
factors, which amplify the two LAPACKs' rounding as the basis conditions
like kappa^l: its histories agree to rtol 1e-5 above 1e-3 of the first
residual (the Gram-LS floor sits near 1e-6) and ``x`` to 1e-6.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.krylov as jk
from repro.core.krylov import pipeline as jpipe
from repro_torch import convert
from repro_torch.core.krylov import (MatFreeOperator, SolverOptions, cg,
                                     dia_inf_norm, pgmres_l, pipecg,
                                     pipecg_l, symmetrized_jacobi)

COOLS_RTOL = 1e-6
FLOOR_REL = 1e-8
WINDOW = 190          # iterations before CG's finite-termination collapse


def _port(A):
    return convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                  grid_shape=A.grid_shape, device="cpu")


@pytest.fixture(scope="module")
def ex23():
    A = jk.tridiagonal_laplacian(200)
    b = np.random.default_rng(0).standard_normal(200)
    return A, b, _port(A), torch.from_numpy(b.copy())


@pytest.fixture(scope="module")
def glen():
    A = jk.glen_law_band(480, bandwidth=10)
    b = np.random.default_rng(2).standard_normal(480)
    return A, b, _port(A), torch.from_numpy(b.copy())


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel_dev(hist, ref, floor_rel=FLOOR_REL):
    h, g = _np(hist), _np(ref)
    k = min(len(h), len(g))
    mask = g[:k] > floor_rel * g.max()
    assert mask.sum() > 0
    return float(np.max(np.abs(h[:k][mask] - g[:k][mask]) / g[:k][mask]))


def _true_res(T, b, x):
    return float(torch.linalg.norm(b - T.matvec(x)))


def test_glen_operator_carries_across(glen):
    A, _, T, _ = glen
    assert T.fingerprint() == A.fingerprint()
    assert len(T.offsets) == 21


def test_depth1_is_pipecg(ex23):
    _, _, T, b = ex23
    r0 = pipecg(T, b, options=SolverOptions(maxiter=80))
    r1 = pipecg_l(T, b, options=SolverOptions(depth=1, maxiter=80))
    np.testing.assert_allclose(r1.res_history.numpy(), r0.res_history.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(r1.x.numpy(), r0.x.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("engine", ["naive", "fused"])
@pytest.mark.parametrize("l", [2, 4])
def test_depth_l_matches_the_reference(ex23, l, engine):
    A, b_np, T, b = ex23
    want = jpipe.pipecg_l(A, jnp.asarray(b_np), l=l, maxiter=200,
                          engine="naive")
    got = pipecg_l(T, b, options=SolverOptions(depth=l, maxiter=200,
                                               engine=engine))
    np.testing.assert_allclose(got.res_history.numpy()[:WINDOW],
                               np.asarray(want.res_history)[:WINDOW],
                               rtol=1e-10)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), xw, rtol=0,
                               atol=1e-10 * np.abs(xw).max())
    assert int(got.iters) == int(want.iters) == 200
    assert got.res_history.shape == (200,)


@pytest.mark.parametrize("l", [2, 4])
def test_depth_l_tracks_cg_within_cools_bound(ex23, l):
    _, _, T, b = ex23
    ref = cg(T, b, options=SolverOptions(maxiter=200))
    r = pipecg_l(T, b, l=l, maxiter=200)
    assert _rel_dev(r.res_history, ref.res_history) < COOLS_RTOL
    assert _true_res(T, b, r.x) < 1e-8 * float(torch.linalg.norm(b))


def test_depth8_exceeds_bound(ex23):
    _, _, T, b = ex23
    ref = cg(T, b, options=SolverOptions(maxiter=200))
    r8 = pipecg_l(T, b, l=8, maxiter=200)
    assert _rel_dev(r8.res_history, ref.res_history) > COOLS_RTOL


def test_residual_replacement_glues_the_true_residual(ex23):
    A, b_np, T, b = ex23
    nb = float(torch.linalg.norm(b))
    r = pipecg_l(T, b, l=4, maxiter=200, rr=5)
    true = _true_res(T, b, r.x)
    assert abs(true - float(r.res_norm)) / nb < 1e-10
    assert true / nb < 1e-9
    want = jpipe.pipecg_l(A, jnp.asarray(b_np), l=4, maxiter=200, rr=5)
    np.testing.assert_allclose(r.res_history.numpy()[:WINDOW],
                               np.asarray(want.res_history)[:WINDOW],
                               rtol=1e-10)


def test_adaptive_rr_keeps_the_periodic_accuracy():
    A = jk.tridiagonal_laplacian(256)
    T = _port(A)
    b = torch.ones(256, dtype=torch.float64)
    base = pipecg_l(T, b, l=2, maxiter=120)
    adaptive = pipecg_l(T, b, l=2, maxiter=120, rr_tau=1e3)
    assert _true_res(T, b, adaptive.x) <= 10 * _true_res(T, b, base.x) + 1e-12
    want = jpipe.pipecg_l(A, jnp.ones(256), l=2, maxiter=120, rr_tau=1e3)
    np.testing.assert_allclose(adaptive.res_history.numpy(),
                               np.asarray(want.res_history), rtol=1e-10)


@pytest.mark.parametrize("rr,replacements", [(0, 0), (2, 2), (3, 1)])
def test_replacement_spmv_runs_only_on_replacement_blocks(ex23, rr,
                                                          replacements):
    """8 iterations at l = 2 are 4 blocks of 3 chain SpMVs plus the
    initial residual's; each replacement block adds exactly one."""
    _, _, T, b = ex23
    calls = []

    def mv(v):
        calls.append(1)
        return T.matvec(v)

    res = pipecg_l(MatFreeOperator(fn=mv, n=T.n), b, l=2, maxiter=8, rr=rr,
                   theta=float(dia_inf_norm(T)))
    assert len(calls) == 1 + 4 * 3 + replacements
    want = pipecg_l(T, b, l=2, maxiter=8, rr=rr)
    assert torch.equal(res.res_history, want.res_history)


@pytest.mark.parametrize("l,rtol", [(2, 1e-10), (4, 1e-8)])
def test_depth_l_glen_jacobi(glen, l, rtol):
    A, b_np, T, b = glen
    r = pipecg_l(T, b, l=l, maxiter=80, M="jacobi")
    assert _true_res(T, b, r.x) < 1e-10 * float(torch.linalg.norm(b))
    want = jpipe.pipecg_l(A, jnp.asarray(b_np), l=l, maxiter=80, M="jacobi")
    h, g = r.res_history.numpy(), np.asarray(want.res_history)
    keep = g > 1e-10 * g.max()
    np.testing.assert_allclose(h[keep], g[keep], rtol=rtol)


def test_fused_engine_matches_naive(ex23, glen):
    _, _, T, b = ex23
    rN = pipecg_l(T, b, l=2, maxiter=100, engine="naive")
    rF = pipecg_l(T, b, l=2, maxiter=100, engine="fused")
    assert _rel_dev(rF.res_history, rN.res_history) < 1e-10
    _, _, G, b2 = glen
    rN2 = pipecg_l(G, b2, l=4, maxiter=60, M="jacobi", engine="naive")
    rF2 = pipecg_l(G, b2, l=4, maxiter=60, M="jacobi", engine="fused")
    assert _rel_dev(rF2.res_history, rN2.res_history) < 1e-8


@pytest.mark.parametrize("l", [2, 4])
def test_tol_freezes_at_block_granularity(l):
    A = jk.laplacian_2d(16, 16)
    T = _port(A)
    b_np = np.random.default_rng(4).standard_normal(256)
    b = torch.from_numpy(b_np.copy())
    r = pipecg_l(T, b, l=l, maxiter=300, tol=1e-8)
    it = int(r.iters)
    assert it < 300 and it % l == 0
    assert float(r.res_norm) <= 1e-8 * float(torch.linalg.norm(b)) * 1.01
    h = r.res_history.numpy()
    assert np.all(h[it:] == h[-1])            # frozen after the block
    want = jpipe.pipecg_l(A, jnp.asarray(b_np), l=l, maxiter=300, tol=1e-8)
    assert it == int(want.iters)


def test_rejects_bad_arguments(ex23):
    _, _, T, b = ex23
    with pytest.raises(ValueError, match="depth"):
        pipecg_l(T, b, l=0)
    with pytest.raises(ValueError, match="symmetrized"):
        pipecg_l(T, b, l=2, M=lambda r: r)
    with pytest.raises(ValueError, match="distributed_solve"):
        pipecg_l(T, b, l=2, engine="sharded_fused")
    with pytest.raises(ValueError, match="theta"):
        pipecg_l(MatFreeOperator(fn=T.matvec, n=T.n), b, l=2)
    with pytest.raises(ValueError, match="options.precision"):
        pipecg_l(T, b, options=SolverOptions(depth=2, precision="bf16"))
    with pytest.raises(ValueError, match="maxiter"):
        pgmres_l(T, b, options=SolverOptions(depth=2, maxiter=7))
    with pytest.raises(ValueError, match="operator scaling"):
        pgmres_l(T, b, l=2, M=lambda r: r)
    with pytest.raises(ValueError, match="depth"):
        pgmres_l(T, b, l=0)


@pytest.mark.parametrize("l", [2, 4])
def test_pgmres_l_matches_the_reference(ex23, l):
    A, b_np, T, b = ex23
    want = jpipe.pgmres_l(A, jnp.asarray(b_np), restart=6 * l, l=l)
    got = pgmres_l(T, b, restart=6 * l, l=l)
    fused = pgmres_l(T, b, restart=6 * l, l=l, engine="fused")
    g = np.asarray(want.res_history)
    keep = g > 1e-3 * g[0]
    np.testing.assert_allclose(got.res_history.numpy()[keep], g[keep],
                               rtol=1e-5)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), xw, rtol=0,
                               atol=1e-6 * np.abs(xw).max())
    assert int(got.iters) == int(want.iters) == 6 * l
    assert torch.equal(fused.res_history, got.res_history)
    # the minimal residual it reports is the true one of its x
    assert abs(_true_res(T, b, got.x) - float(got.res_norm)) < 1e-6


def test_pgmres_l_jacobi_matches_the_reference(glen):
    A, b_np, T, b = glen
    want = jpipe.pgmres_l(A, jnp.asarray(b_np), restart=12, l=2, M="jacobi")
    got = pgmres_l(T, b, restart=12, l=2, M="jacobi")
    g = np.asarray(want.res_history)
    keep = g > 1e-3 * g[0]
    np.testing.assert_allclose(got.res_history.numpy()[keep], g[keep],
                               rtol=1e-5)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), xw, rtol=0,
                               atol=1e-6 * np.abs(xw).max())
    assert _true_res(T, b, got.x) < 1e-3 * float(torch.linalg.norm(b))


@pytest.mark.parametrize("name", ["ex23", "lap2d", "glen"])
def test_symmetrized_jacobi_and_inf_norm_equal_the_reference(name):
    A = {"ex23": jk.tridiagonal_laplacian(97),
         "lap2d": jk.laplacian_2d(12, 9),
         "glen": jk.glen_law_band(150, bandwidth=10)}[name]
    T = _port(A)
    b_np = np.random.default_rng(5).standard_normal(A.n)
    Aw, bw, dw = jpipe.symmetrized_jacobi(A, jnp.asarray(b_np))
    At, bt, dt = symmetrized_jacobi(T, torch.from_numpy(b_np.copy()))
    assert At.offsets == tuple(Aw.offsets)
    # XLA may rewrite 1/sqrt(d) as rsqrt(d): an ulp off the division,
    # a few ulps once squared into the bands
    for got, want in ((At.bands, Aw.bands), (bt, bw), (dt, dw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15, atol=0)
    # the row sums of 21 bands are folded in another order than XLA's
    assert float(dia_inf_norm(T)) == pytest.approx(
        float(jpipe.dia_inf_norm(A)), rel=1e-15, abs=0)
