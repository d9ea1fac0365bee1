"""The port's solvers and options against the JAX reference.

The same numpy operator and right-hand sides go to both packages.  The
port's fused engine runs the kernels' plain versions here; the reference's
fused engine reaches Pallas kernels that do not run on this CPU, so the
single-sweep path is held against the reference's own ``_pipecg_engine``
driving ``kernels/ref.py``'s sweep oracle (``_RefSweep`` below), and
everything else against ``engine="naive"`` / ``engine=None``.

Tolerances: residual histories to rtol 1e-10 above a 1e-10 relative floor
(the reference's ``_hist_close``), ``iters`` and shapes exactly.  Float64
CG drifts by rounding order at about 1e-12 per iteration on these
operators, so the histories are kept to at most 80 iterations; bf16
storage amplifies a last-bit difference by ~3x per iteration, so its
history is compared over the first 12.
"""
import dataclasses
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.krylov as jk
from repro.core.krylov.engine import FusedEngine as JFused
from repro.core.krylov.engine import _ip_pick, _jacobi_inv_diag
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core.krylov import (PrecisionPolicy, SolverOptions, cg, cr,
                                     pipecg, pipecg_multi, pipecr)
from repro_torch.core.krylov.engine import get_engine
from repro_torch.core.krylov.operators import MatFreeOperator
from repro_torch.core.krylov.options import (check_supported,
                                             reset_deprecation_warning,
                                             resolve_options)
from repro_torch.kernels import ops

jcg = importlib.import_module("repro.core.krylov.cg")


class _RefSweep(JFused):
    """The reference FusedEngine with its kernel calls replaced by ref.py.

    The single-sweep iteration goes through ``ref.pipecg_spmv_fused_ref``
    (stores narrowed to the carried dtype, as the kernel does) and the
    standalone SpMV through the operator's jnp matvec.
    """

    name = "ref_sweep"

    def _spmv(self, A, v):
        return A.matvec(v)

    def pipecg_iter(self, A, M, ip, st, alpha, beta):
        assert "w" not in st
        one = st["x"].ndim == 1
        f = (lambda v: v[None]) if one else (lambda v: v)
        inv_d = _jacobi_inv_diag(A, M, st["x"].shape[-1], A.dtype)
        x, r, u, p, red = ref.pipecg_spmv_fused_ref(
            A.offsets, A.bands, inv_d, *(f(st[k]) for k in "xrup"),
            f(jnp.asarray(alpha)), f(jnp.asarray(beta)))
        r, u, p = (v.astype(st[k].dtype) for v, k in zip((r, u, p), "rup"))
        if one:
            x, r, u, p, red = (v[0] for v in (x, r, u, p, red))
        gamma, delta = _ip_pick(ip, red[..., 0], red[..., 1], red[..., 3],
                                red[..., 4])
        return (dict(x=x, r=r, u=u, p=p), gamma, delta, red[..., 2],
                dict(chk=red[..., 5], ww=red[..., 4]))


def _hist_close(ref_hist, got, rtol=1e-10, floor_rel=1e-10):
    hr = np.asarray(ref_hist)
    hg = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert hr.shape == hg.shape
    mask = hr > floor_rel * max(hr.max(), 1.0)
    assert mask.sum() > 0
    np.testing.assert_allclose(hg[mask], hr[mask], rtol=rtol)


def _pair(A):
    return A, convert.dia_from_numpy(A.offsets, np.asarray(A.bands),
                                     grid_shape=A.grid_shape, device="cpu")


def _spd_tridiag(n, seed):
    """Symmetric tridiagonal SPD with a varying diagonal (Jacobi matters).

    Barely diagonally dominant, so CG converges slowly, as on ex23.
    """
    rng = np.random.default_rng(seed)
    off = -rng.uniform(0.5, 1.0, n)
    lo = np.concatenate([[0.0], off[:-1]])   # A[i, i-1] = off[i-1]
    hi = np.concatenate([off[:-1], [0.0]])   # A[i, i+1] = off[i]
    main = np.abs(lo) + np.abs(hi) + rng.uniform(1e-3, 2e-2, n)
    return jk.DiaMatrix(offsets=(-1, 0, 1),
                        bands=jnp.asarray(np.stack([lo, main, hi])))


@pytest.fixture(scope="module")
def tri():
    A, T = _pair(jk.tridiagonal_laplacian(200))
    b = np.random.default_rng(0).standard_normal(200)
    return A, T, b


@pytest.fixture(scope="module")
def lap2d():
    A, T = _pair(jk.laplacian_2d(12, 10))
    b = np.random.default_rng(1).standard_normal(120)
    return A, T, b


def _t(b):
    return torch.from_numpy(np.array(b))


# -- classical and pipelined CG/CR, inline and engines ----------------------

@pytest.mark.parametrize("solver", ["cg", "cr", "pipecg", "pipecr"])
@pytest.mark.parametrize("engine", [None, "naive", "fused"])
def test_solvers_match_reference(tri, solver, engine):
    A, T, b = tri
    jfn = getattr(jk, solver)
    tfn = dict(cg=cg, cr=cr, pipecg=pipecg, pipecr=pipecr)[solver]
    want = jfn(A, jnp.asarray(b), options=jk.SolverOptions(maxiter=60))
    got = tfn(T, _t(b), options=SolverOptions(maxiter=60, engine=engine))
    _hist_close(want.res_history, got.res_history)
    assert int(got.iters) == int(want.iters) == 60
    assert tuple(got.x.shape) == (200,)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(want.x)).max())


@pytest.mark.parametrize("M", [None, "jacobi"])
@pytest.mark.parametrize("ip", ["id", "A"])
def test_fused_sweep_matches_reference_sweep(M, ip):
    A, T = _pair(_spd_tridiag(150, seed=3))
    b = np.random.default_rng(2).standard_normal(150)
    want = jcg._pipecg_engine(A, jnp.asarray(b), maxiter=50, M=M, ip=ip,
                              engine=_RefSweep())
    solver = pipecr if ip == "A" else pipecg
    got = solver(T, _t(b), options=SolverOptions(maxiter=50, M=M,
                                                 engine="fused"))
    _hist_close(want.res_history, got.res_history)
    np.testing.assert_allclose(got.detect_history.numpy(),
                               np.asarray(want.detect_history), rtol=0,
                               atol=1e-12)
    assert int(got.iters) == int(want.iters)


def test_fused_2d_laplacian_matches_naive(lap2d):
    A, T, b = lap2d
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=15, engine="naive"))
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=15, engine="fused"))
    _hist_close(want.res_history, got.res_history)


@pytest.mark.parametrize("engine", ["naive", "fused"])
def test_tol_freeze_counts_iters_exactly(engine):
    A, T = _pair(_spd_tridiag(120, seed=12))
    b = np.random.default_rng(4).standard_normal(120)
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=100, tol=3e-2,
                                              engine="naive"))
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=100, tol=3e-2,
                                                 engine=engine))
    assert int(got.iters) == int(want.iters) < 100
    assert tuple(got.res_history.shape) == (100,)
    _hist_close(want.res_history, got.res_history)
    # frozen: the state after the freeze is the state at the freeze
    xw = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), xw, rtol=1e-9,
                               atol=1e-9 * np.abs(xw).max())


def test_inline_cg_tol_freeze():
    A, T = _pair(_spd_tridiag(120, seed=13))
    b = np.random.default_rng(5).standard_normal(120)
    want = jk.cg(A, jnp.asarray(b), options=jk.SolverOptions(maxiter=100,
                                                             tol=3e-2))
    got = cg(T, _t(b), options=SolverOptions(maxiter=100, tol=3e-2))
    assert int(got.iters) == int(want.iters) < 100
    _hist_close(want.res_history, got.res_history)


# -- batched, preconditioned, fallback ---------------------------------------

def test_pipecg_multi_matches_reference_and_single_solves(tri):
    A, T, _ = tri
    B = np.random.default_rng(6).standard_normal((4, 200))
    want = jk.pipecg_multi(A, jnp.asarray(B), maxiter=50, engine="naive")
    got = pipecg_multi(T, _t(B), maxiter=50, engine="fused")
    assert tuple(got.res_history.shape) == (4, 50)
    assert tuple(got.x.shape) == (4, 200)
    _hist_close(want.res_history, got.res_history)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for j in range(4):
        one = pipecg(T, _t(B[j]), options=SolverOptions(maxiter=50,
                                                        engine="fused"))
        _hist_close(one.res_history, got.res_history[j], rtol=1e-12)


def test_pipecg_multi_naive_engine_loops_rows(tri):
    A, T, _ = tri
    B = np.random.default_rng(7).standard_normal((2, 200))
    want = jk.pipecg_multi(A, jnp.asarray(B), maxiter=40, engine="naive",
                           tol=1e-3)
    got = pipecg_multi(T, _t(B), maxiter=40, engine="naive", tol=1e-3)
    _hist_close(want.res_history, got.res_history)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def test_jacobi_matches_reference():
    A, T = _pair(_spd_tridiag(180, seed=8))
    b = np.random.default_rng(9).standard_normal(180)
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=50, M="jacobi",
                                              engine="naive"))
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=50, M="jacobi",
                                                 engine="fused"))
    _hist_close(want.res_history, got.res_history)


def test_callable_M_takes_the_update_kernel_fallback():
    A, T = _pair(_spd_tridiag(160, seed=10))
    b = np.random.default_rng(11).standard_normal(160)
    dj = np.asarray(A.diagonal())
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=50, engine="naive",
                                              M=lambda z: z / dj))
    dt = torch.from_numpy(dj.copy())
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=50, engine="fused",
                                                 M=lambda z: z / dt))
    _hist_close(want.res_history, got.res_history)
    assert sum(ops.launch_counts().values()) == 0  # CPU: plain versions only


def test_matrix_free_operator_fallback(tri):
    A, T, b = tri
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=40, engine="naive"))
    mf = MatFreeOperator(fn=T.matvec, n=T.n)
    got = pipecg(mf, _t(b), options=SolverOptions(maxiter=40, engine="fused"))
    _hist_close(want.res_history, got.res_history)
    assert float(got.detect_history.abs().max()) == 0.0  # no checksum


def test_adaptive_residual_replacement_matches_reference(tri):
    A, T, b = tri
    tau = 1e-14  # the deviation estimate trips after ~15 iterations
    want = jk.pipecg(A, jnp.asarray(b),
                     options=jk.SolverOptions(maxiter=40, engine="naive",
                                              rr_tau=tau))
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=40, engine="fused",
                                                 rr_tau=tau))
    plain = pipecg(T, _t(b), options=SolverOptions(maxiter=40,
                                                   engine="fused"))
    assert not torch.equal(got.res_history, plain.res_history)  # re-glued
    _hist_close(want.res_history, got.res_history)


def test_bf16_storage_matches_reference_sweep(tri):
    A, T, b = tri
    want = jcg._pipecg_engine(A, jnp.asarray(b), maxiter=12,
                              engine=_RefSweep(), precision="bf16")
    got = pipecg(T, _t(b), options=SolverOptions(maxiter=12, engine="fused",
                                                 precision="bf16"))
    assert got.x.dtype == torch.float64
    _hist_close(want.res_history, got.res_history)
    assert int(got.iters) == int(want.iters)


# -- errors ------------------------------------------------------------------

def test_engine_errors(tri):
    _, T, b = tri
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipecg(T, _t(b), options=SolverOptions(maxiter=5,
                                               engine="sharded_fused"))
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("warp")
    with pytest.raises(ValueError, match="custom dot"):
        pipecg(T, _t(b), dot=lambda a, c: (a * c).sum(),
               options=SolverOptions(maxiter=5, engine="naive"))
    with pytest.raises(ValueError, match="engine path"):
        pipecg(T, _t(b), options=SolverOptions(maxiter=5, rr_tau=1.0))


def test_precision_errors(tri):
    _, T, b = tri
    with pytest.raises(ValueError, match="wire"):
        pipecg(T, _t(b), options=SolverOptions(
            maxiter=5, engine="fused", precision="bf16_int8wire"))
    with pytest.raises(ValueError, match="DiaMatrix"):
        pipecg(MatFreeOperator(fn=T.matvec, n=T.n), _t(b),
               options=SolverOptions(maxiter=5, engine="fused",
                                     precision="bf16"))
    with pytest.raises(ValueError, match="single-sweep"):
        pipecg(T, _t(b), options=SolverOptions(maxiter=5, engine="naive",
                                               precision="bf16"))


# -- options (the cases of tests/test_options.py) ----------------------------

@pytest.fixture
def Ab():
    A, T = _pair(jk.tridiagonal_laplacian(64))
    return T, torch.ones(64, dtype=torch.float64)


def test_options_equivalent_to_legacy_bit_identical(Ab):
    T, b = Ab
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = pipecg(T, b, maxiter=40, tol=1e-12)
        legacy_fused = pipecg(T, b, maxiter=25, engine="fused")
    typed = pipecg(T, b, options=SolverOptions(maxiter=40, tol=1e-12))
    assert torch.equal(legacy.x, typed.x)
    assert torch.equal(legacy.res_history, typed.res_history)
    typed = pipecg(T, b, options=SolverOptions(maxiter=25, engine="fused"))
    assert torch.equal(legacy_fused.x, typed.x)


def test_mixing_options_and_legacy_raises(Ab):
    T, b = Ab
    with pytest.raises(TypeError, match="cannot mix"):
        pipecg(T, b, maxiter=5, options=SolverOptions())
    with pytest.raises(TypeError, match="SolverOptions"):
        resolve_options({"maxiter": 5})


def test_unknown_key_and_l_alias():
    with pytest.raises(TypeError) as exc:
        SolverOptions.from_kwargs(maxiters=5)
    for word in ("maxiters", "maxiter", "precision"):
        assert word in str(exc.value)
    assert SolverOptions.from_kwargs(l=3).depth == 3
    with pytest.raises(TypeError, match="not both"):
        SolverOptions.from_kwargs(l=2, depth=2)


def test_deprecation_warns_exactly_once_per_process():
    reset_deprecation_warning()
    with pytest.warns(DeprecationWarning, match="options=SolverOptions"):
        SolverOptions.from_kwargs(M=None, rr=2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        SolverOptions.from_kwargs(engine="fused")
    assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]
    reset_deprecation_warning()


def test_check_supported_rejects_unhonored_fields(Ab):
    T, b = Ab
    with pytest.raises(ValueError, match="does not honor options.depth"):
        cg(T, b, options=SolverOptions(depth=2, maxiter=5))
    with pytest.raises(ValueError, match="rr_tau"):
        cg(T, b, options=SolverOptions(rr_tau=1.0, maxiter=5))
    with pytest.raises(ValueError, match="engine path"):
        pipecg(T, b, options=SolverOptions(maxiter=5, precision="bf16"))
    check_supported(SolverOptions(), "anything", supported=())


@pytest.mark.parametrize("name", ["fp32", "bf16", "bf16_int8wire",
                                  "bf16_int8wire_noef", "bf16_int8allwire",
                                  "fp8"])
def test_precision_presets_match_reference(name):
    want = jk.PrecisionPolicy.from_name(name)
    got = convert.policy_from_name(name)
    assert got == PrecisionPolicy(**{f: getattr(want, f) for f in (
        "storage", "accum", "wire", "error_feedback", "wire_gram")})
    for prop in ("storage_eps", "storage_words", "wire_words", "is_default"):
        assert getattr(got, prop) == getattr(want, prop)
    sdt = {None: None, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}
    want_dt = None if want.storage_dtype is None else \
        jnp.dtype(want.storage_dtype).name
    assert got.storage_dtype is sdt[want_dt]


def test_precision_policy_errors_and_coercion():
    with pytest.raises(ValueError, match="accum"):
        PrecisionPolicy(accum="bf16")
    with pytest.raises(ValueError, match="bf16_int8wire"):
        PrecisionPolicy.from_name("int4")
    opts = SolverOptions(precision="bf16")
    assert isinstance(opts.precision, PrecisionPolicy)
    assert opts.precision.storage == "bf16"


@pytest.mark.parametrize("kw", [dict(maxiter=7, tol=1e-3),
                                dict(engine="fused", rr_tau=2.0),
                                dict(l=3, M="jacobi")])
def test_resolved_fields_match_reference(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jk.SolverOptions.from_kwargs(**dict(kw))
        got = SolverOptions.from_kwargs(**dict(kw))
    for f in ("maxiter", "tol", "M", "engine", "depth", "rr", "rr_tau",
              "noise"):
        assert getattr(got, f) == getattr(want, f)


# -- ABFT detectors (core/krylov/abft.py) ------------------------------------

def test_abft_detectors_match_reference():
    from repro.core.krylov import abft as jab
    from repro_torch.core.krylov import abft as tab
    for dt_j, dt_t in ((jnp.float64, torch.float64),
                       (jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        assert tab.machine_eps(dt_t) == jab.machine_eps(dt_j)
    assert tab.checksum_threshold(3.5, 1000, torch.float64) == \
        jab.checksum_threshold(3.5, 1000, jnp.float64)
    rng = np.random.default_rng(14)
    dev, alpha, rr2, ww = (rng.uniform(0.0, 2.0, 5) for _ in range(4))
    rr2[0] = -1e-30  # clamped at zero
    eps = tab.machine_eps(torch.float64)
    want = jab.deviation_update(jnp.asarray(dev), jnp.asarray(alpha),
                                jnp.asarray(rr2), jnp.asarray(ww), eps=eps)
    got = tab.deviation_update(*(torch.from_numpy(v) for v in
                                 (dev, alpha, rr2, ww)), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    np.testing.assert_array_equal(
        tab.deviation_trip(got, torch.from_numpy(rr2), 0.7).numpy(),
        np.asarray(jab.deviation_trip(want, jnp.asarray(rr2), 0.7)))
    fields = [f.name for f in dataclasses.fields(tab.DetectionReport)]
    assert fields == [f.name for f in dataclasses.fields(jab.DetectionReport)]
    rep = tab.DetectionReport(solver="pipecg", detector="checksum",
                              tripped=False)
    assert (rep.trip_iter, rep.action, rep.tau) == (-1, "none", tab.DEFAULT_TAU)
