"""The rest of the port's stochastic model against the JAX package.

Closed forms agree to 1e-12 (relative): the folk theorem (Eq. 1/2/5),
Eq. 6/7, ``comm``'s surface-to-volume terms, and ``predict_speedup`` /
``ex23_models`` fed the reference's own ``Hardware`` fields through
``convert.model_from_fields`` (the port's defaults are H100 figures, so
the comparison carries the reference's numbers across instead of writing
them into the port).  The statistics of Section 4 (ECDF, MLE fits,
Cramer-von Mises, Lilliefors, the report) agree to 1e-12 on the same
samples, with the same verdicts.  The port's own draws (``generate_runs``
through a ``torch.Generator``, the bootstrap, ``makespan_trace_large``)
are not the JAX package's numpy draws, so they are held statistically,
as the reference's own tests hold them.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.noise.simulator as jsim
import repro.core.noise.traces as jtr
import repro.core.perfmodel.comm as jcomm
import repro.core.perfmodel.distributions as jd
import repro.core.perfmodel.folk_theorem as jfolk
import repro.core.perfmodel.queueing as jq
import repro.core.stats as jstats
from repro_torch import convert
from repro_torch.core import stats
from repro_torch.core.noise import (EX23_ITERS, EX23_N, PIZ_DAINT_P, TABLE1,
                                    Hardware, calibrated_model, ex23_models,
                                    generate_runs, makespan_trace_large,
                                    predict_speedup, trace_distribution)
from repro_torch.core.noise.simulator import apply_precision
from repro_torch.core.perfmodel import (Exponential, LogNormal, Uniform,
                                        comm, folk_theorem, harmonic,
                                        queueing, simulate)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
# (port distribution, JAX distribution) pairs
DISTS = {
    "exponential": (Exponential(2.0), jd.Exponential(2.0)),
    "uniform": (Uniform(0.5, 1.5), jd.Uniform(0.5, 1.5)),
    "lognormal": (LogNormal(0.1, 0.5), jd.LogNormal(0.1, 0.5)),
}


def _close(got, want, rel=REL):
    assert got == pytest.approx(want, rel=rel, abs=1e-300)


# -- Section 2: the folk theorem ------------------------------------------

def test_folk_theorem_matches_the_reference():
    t = [0.7, 1.3, 0.9]
    got = folk_theorem.deterministic_makespans(t, 50)
    want = jfolk.deterministic_makespans(t, 50)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0] == got[1]   # deterministic times admit no speedup
    for W, T0, K, P in ((5.0, 1.0, 10, 2), (3.0, 0.5, 4, 4), (2.0, 1.0, 2, 3)):
        trace = folk_theorem.staggered_delay_trace(W, T0, K, P, device="cpu")
        jtrace = jfolk.staggered_delay_trace(W, T0, K, P)
        np.testing.assert_array_equal(trace.numpy(), np.asarray(jtrace))
        for g, w in zip(folk_theorem.trace_makespans(trace),
                        jfolk.trace_makespans(jtrace)):
            _close(g, w)
    rng = np.random.default_rng(0)
    times = rng.exponential(1.0, (40, 8))
    for g, w in zip(folk_theorem.trace_makespans(torch.from_numpy(times)),
                    jfolk.trace_makespans(jnp.asarray(times))):
        _close(g, w)
    for P in (2, 4, 8192):
        assert folk_theorem.folk_bound(P) == jfolk.folk_bound(P) == P
    for alpha in (0.0, 0.5, 10.0):
        _close(folk_theorem.overlap_speedup_bound(alpha),
               jfolk.overlap_speedup_bound(alpha))
    # Eq. (5) on the staggered trace: T/T' = (2 + alpha)/(1 + alpha)
    W, T0, K = 4.0, 1.0, 12
    T, Tp = folk_theorem.trace_makespans(
        folk_theorem.staggered_delay_trace(W, T0, K, 2, device="cpu"))
    alpha = K * T0 / (W - T0)
    _close(T / Tp, folk_theorem.overlap_speedup_bound(alpha))
    assert T / Tp <= folk_theorem.folk_bound(2)


# -- Eq. 6/7 ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(DISTS))
def test_eq6_eq7_match_the_reference(name):
    ours, theirs = DISTS[name]
    for P, tc, R, tw in ((1, 0.0, 0.0, 0.0), (4, 1.0, 0.5, 0.1),
                         (8192, 2e-3, 3e-4, 1e-5)):
        _close(queueing.eq6_iteration_time(ours, P, tc, R, tw,
                                           device="cpu"),
               jq.eq6_iteration_time(theirs, P, tc, R, tw),
               rel=REL if name != "lognormal" else 1e-10)
        _close(queueing.eq7_iteration_time(ours, tc, R, tw),
               jq.eq7_iteration_time(theirs, tc, R, tw))


def test_eq6_eq7_against_simulated_step_means():
    """Eq. 6 is the synchronized step mean sum_k max_p / K, Eq. 7's
    noise-only form the pipelined per-process mean (a Monte-Carlo check
    at a small size; chip_smoke.py runs it at P = 8192)."""
    P, K = 16, 400
    dist = Exponential(1.0)
    ms = simulate(dist, P, K, trials=64, seed=3, device="cpu")
    step_sync = float(ms.t_sync.mean()) / K
    assert step_sync == pytest.approx(
        queueing.eq6_iteration_time(dist, P, device="cpu"), rel=0.02)
    assert queueing.eq6_iteration_time(dist, P, device="cpu") \
        == pytest.approx(harmonic(P), rel=1e-15)
    assert queueing.eq7_iteration_time(dist) == 1.0
    assert float(ms.t_async.mean()) / K >= queueing.eq7_iteration_time(dist)


# -- comm ------------------------------------------------------------------

def test_comm_matches_the_reference():
    for pts, grid in (((1024,), (4,)), ((16, 16), (2, 2)), ((16, 8), (4, 1)),
                      ((12, 12, 12), (2, 3, 2))):
        assert comm.local_extents(pts, grid) == jcomm.local_extents(pts,
                                                                    grid)
    for bad in (((16, 16), (4,)), ((16, 16), (3, 2))):
        with pytest.raises(ValueError):
            comm.local_extents(*bad)
    for ext, w in (((256,), (1,)), ((8, 8), (1, 1)), ((16, 4), (2, 1)),
                   ((6, 4, 6), (1, 2, 1))):
        assert comm.halo_messages(len(ext)) == jcomm.halo_messages(len(ext))
        assert comm.halo_elems(ext, w) == jcomm.halo_elems(ext, w)
        _close(comm.surface_to_volume(ext, w),
               jcomm.surface_to_volume(ext, w))
        kw = dict(n_halo_vecs=2, dtype_bytes=8, wire_words=0.5,
                  link_bw=450e9, hop_latency=1.8e-5)
        _close(comm.halo_wire_time(ext, w, **kw),
               jcomm.halo_wire_time(ext, w, **kw))
    for pts, p in (((1448, 1448), 4), ((64, 32), 8), ((1024,), 16),
                   ((30, 20, 10), 12)):
        assert comm.best_grid(pts, p) == jcomm.best_grid(pts, p)
    with pytest.raises(ValueError, match="no process grid"):
        comm.best_grid((4, 4), 64)


# -- the phase model -------------------------------------------------------

def _port_models(p):
    """ex23_models of the port over the reference's hardware fields."""
    return ex23_models(p, convert.model_from_fields(
        "Hardware", dataclasses.asdict(jsim.Hardware())))


def test_hardware_defaults_are_the_cards_not_the_reference():
    ours, theirs = Hardware(), jsim.Hardware()
    for f in dataclasses.fields(theirs):
        assert getattr(ours, f.name) != getattr(theirs, f.name), f.name
    # the H100 SXM data sheet and the measured hop
    assert ours.hbm_bw == 3.35e12 and ours.peak_flops == 989e12
    assert ours.f64_flops == 34e12 and ours.link_bw == 450e9
    assert 1e-6 < ours.hop_latency < 1e-4


def test_model_from_fields_carries_every_field():
    jm = jsim.SolverPhaseModel(n=4096, nnz_per_row=5, p=4, halo=2,
                               storage_words=0.5, grid=(2, 2),
                               grid_points=(64, 64))
    m = convert.model_from_fields("SolverPhaseModel", dataclasses.asdict(jm))
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    run = convert.model_from_fields(
        "RunModel", dataclasses.asdict(jtr.calibrated_model("PGMRES")))
    assert run == calibrated_model("PGMRES")
    with pytest.raises(ValueError, match="no port counterpart"):
        convert.model_from_fields("Queue", {})


@pytest.mark.parametrize("p", [1, 4, 8192])
@pytest.mark.parametrize("pair", [("cg", "pipecg"),
                                  ("bicgstab", "pipebicgstab")])
@pytest.mark.parametrize("kw", [
    {}, {"depth": 2}, {"precision": "bf16"}, {"depth": 4,
                                              "precision": "bf16_int8wire"}],
    ids=["plain", "depth2", "bf16", "depth4-int8wire"])
def test_predict_speedup_matches_the_reference(p, pair, kw):
    ours, theirs = _port_models(p), jsim.ex23_models(p)
    for name in pair:
        for term in ("t_spmv", "t_axpy", "t_reduction", "t_halo",
                     "t_compute"):
            _close(getattr(ours[name], term)(), getattr(theirs[name], term)())
    noise = (Exponential(1e4), jd.Exponential(1e4))
    got = predict_speedup(ours[pair[0]], ours[pair[1]], noise[0], K=5000,
                          device="cpu", **kw)
    want = jsim.predict_speedup(theirs[pair[0]], theirs[pair[1]], noise[1],
                                K=5000, **kw)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], float(want[key]))


def test_predict_speedup_on_a_grid_with_a_halo():
    jm = jsim.SolverPhaseModel(n=1448 * 1448, nnz_per_row=5, p=4, halo=1,
                               n_vec_reads=14, n_reductions=1)
    m = convert.model_from_fields("SolverPhaseModel", dataclasses.asdict(jm))
    for grid in ((2, 2), (4, 1)):
        got = predict_speedup(m, m, Exponential(1e5), K=100, grid=grid,
                              grid_points=(1448, 1448), device="cpu")
        want = jsim.predict_speedup(jm, jm, jd.Exponential(1e5), K=100,
                                    grid=grid, grid_points=(1448, 1448))
        for key in want:
            _close(got[key], float(want[key]))
    with pytest.raises(ValueError, match="grid_points"):
        predict_speedup(m, m, Exponential(1.0), K=1, grid=(2, 2))
    lo = apply_precision(m, "bf16")
    assert lo.storage_words == 0.5 and apply_precision(m, None) is m


def test_four_sync_latency_regime_on_the_card_defaults():
    """tests/test_bicgstab.py::test_predict_speedup_four_sync_latency_regime
    under the H100 ``Hardware()``: at Piz Daint scale with vanishing noise
    the four-sync pair models ~4x and the CG pair ~2x."""
    tiny = Exponential(1e12)
    m = ex23_models(p=PIZ_DAINT_P)
    four = predict_speedup(m["bicgstab"], m["pipebicgstab"], tiny, K=100,
                           device="cpu")
    two = predict_speedup(m["cg"], m["pipecg"], tiny, K=100, device="cpu")
    assert four["speedup"] == pytest.approx(4.0, rel=0.01)
    assert two["speedup"] == pytest.approx(2.0, rel=0.01)
    assert four["speedup"] > 2.0
    assert four["pipe_latency_bound"] == 1.0


# -- Table 1: the calibrated generator -----------------------------------

def test_table1_constants_match_the_reference():
    assert TABLE1 == jtr.TABLE1
    assert (PIZ_DAINT_P, EX23_N, EX23_ITERS) == (jtr.PIZ_DAINT_P, jtr.EX23_N,
                                                 jtr.EX23_ITERS)
    for alg in TABLE1:
        m, jm = calibrated_model(alg), jtr.calibrated_model(alg)
        _close(m.base, jm.base)
        _close(m.scale, jm.scale)
        row = TABLE1[alg]
        assert m.base + m.scale == pytest.approx(row["mean"], rel=1e-9)
        assert m.base + m.scale / row["n"] == pytest.approx(row["min"],
                                                            rel=1e-9)


def test_generate_runs_is_seeded_and_above_the_base():
    a = generate_runs("PIPECG", seed=5, device="cpu")
    assert a.dtype == torch.float64 and tuple(a.shape) == (20,)
    assert torch.equal(a, generate_runs("PIPECG", seed=5, device="cpu"))
    assert not torch.equal(a, generate_runs("PIPECG", seed=6, device="cpu"))
    assert not torch.equal(a[:12], generate_runs("GMRES", n=12, seed=5,
                                                 device="cpu"))
    assert float(a.min()) > calibrated_model("PIPECG").base
    big = generate_runs("CG", n=20000, seed=1, device="cpu")
    m = calibrated_model("CG")
    assert float(big.mean()) == pytest.approx(m.base + m.scale, rel=0.02)
    trace = trace_distribution("PGMRES", n=64, seed=2, device="cpu")
    assert trace.trace_name == "trace:PGMRES" and len(trace.samples) == 64
    assert list(trace.samples) == sorted(trace.samples)


@pytest.mark.parametrize("alg", list(TABLE1))
def test_generated_stats_near_table1(alg):
    rows = [stats.fit_report(generate_runs(alg, seed=s, device="cpu"),
                             name=alg).summary for s in range(8)]
    assert np.mean([r["mean"] for r in rows]) == pytest.approx(
        TABLE1[alg]["mean"], rel=0.15)
    assert np.mean([r["median"] for r in rows]) == pytest.approx(
        TABLE1[alg]["median"], rel=0.2)


def test_verdicts_match_paper_conclusions():
    """tests/test_table1.py's aggregate over seeds on the port's own draws:
    uniform mostly rejected for the n = 20 CG family, the shifted
    exponential rarely."""
    rej_uniform_cg = rej_exp_total = 0
    n_seeds = 10
    for s in range(n_seeds):
        for alg in ("CG", "PIPECG"):
            rep = stats.fit_report(generate_runs(alg, seed=s, device="cpu"),
                                   name=alg)
            rej_uniform_cg += rep.uniform.reject
            rej_exp_total += rep.exponential.reject
    assert rej_uniform_cg / (2 * n_seeds) > 0.5
    assert rej_exp_total / (2 * n_seeds) < 0.3


# -- Section 4: the statistics ------------------------------------------------

@pytest.mark.parametrize("alg", list(TABLE1))
@pytest.mark.parametrize("seed", [0, 4])
def test_fit_report_on_reference_samples(alg, seed):
    """The port's report on the JAX package's samples: the same Table-1
    row and the same table-route verdicts, statistics to 1e-12."""
    x = jtr.generate_runs(alg, seed=seed)
    got = stats.fit_report(x, name=alg)
    want = jstats.fit_report(x, name=alg)
    assert set(got.summary) == set(want.summary)
    for key, w in want.summary.items():
        _close(got.summary[key], w)
    assert got.verdicts() == want.verdicts()
    for test in ("uniform", "exponential", "exponential_origin",
                 "lognormal"):
        g, w = getattr(got, test), getattr(want, test)
        _close(g.statistic, w.statistic)
        _close(g.modified_statistic, w.modified_statistic)
        assert (g.critical_value, g.reject, g.method) == \
            (w.critical_value, w.reject, w.method)
    assert got.table_row() == want.table_row()
    assert got.verdict_row() == want.verdict_row()


def test_fits_ecdf_and_statistics_match_the_reference():
    rng = np.random.default_rng(7)
    x = 0.5 + rng.exponential(0.3, 40)
    for fam in stats.FITTERS:
        g, w = stats.FITTERS[fam](x), jstats.FITTERS[fam](x)
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if dataclasses.is_dataclass(wv):
                for ff in dataclasses.fields(wv):
                    _close(getattr(gv, ff.name), getattr(wv, ff.name))
            else:
                _close(gv, wv)
    xs, F = stats.ecdf(x)
    jx, jF = jstats.ecdf(x)
    np.testing.assert_array_equal(xs.numpy(), jx)
    np.testing.assert_array_equal(F.numpy(), jF)
    pts = np.linspace(0.4, 2.0, 17)
    np.testing.assert_array_equal(stats.ecdf_at(x, pts).numpy(),
                                  jstats.ecdf_at(x, pts))
    _, _, fits = stats.ecdf_with_fits(x)
    _, _, jfits = jstats.ecdf_with_fits(x)
    assert set(fits) == set(jfits)
    for fam in jfits:
        np.testing.assert_allclose(fits[fam].numpy(), jfits[fam],
                                   rtol=1e-12, atol=1e-15)
    _close(stats.lilliefors_statistic(np.log(x)),
           jstats.lilliefors_statistic(np.log(x)))
    _close(stats.cvm_statistic(x, Exponential(2.0).cdf),
           jstats.cvm_statistic(x, jd.Exponential(2.0).cdf))
    # tensors on any device are samples too
    assert stats.summary_statistics(torch.from_numpy(x)) \
        == stats.summary_statistics(x)


def test_cvm_formula_manual():
    x = np.array([0.1, 0.5, 0.9])
    manual = 1 / 36 + sum(((2 * (i + 1) - 1) / 6 - x[i]) ** 2
                          for i in range(3))
    assert stats.cvm_statistic(x, lambda v: v) == pytest.approx(manual)


def test_bootstrap_critical_close_to_table():
    """tests/test_stats.py's bootstrap check, through the port's
    torch.Generator: the exponential case's bootstrap critical value lands
    near Stephens' tabulated 0.224."""
    x = np.random.default_rng(11).exponential(1.0, size=20)
    bt = stats.cramer_von_mises(x, "exponential", bootstrap=400, seed=3)
    assert bt.method == "bootstrap"
    assert 0.1 < bt.critical_value < 0.4
    again = stats.cramer_von_mises(x, "exponential", bootstrap=400, seed=3)
    assert again.critical_value == bt.critical_value


def test_lilliefors_table_and_monte_carlo():
    from repro.core.stats.lilliefors import critical_value_05 as jcrit
    from repro_torch.core.stats.lilliefors import critical_value_05
    for n in (3, 4, 12, 21, 27, 30, 50, 400):
        _close(critical_value_05(n), jcrit(n))
    z = np.random.default_rng(2).standard_normal(30)
    mc = stats.lilliefors(z, mc=300, seed=1)
    assert mc.method == "mc"
    assert mc.critical_value == pytest.approx(critical_value_05(30),
                                              rel=0.25)
    assert not stats.lilliefors(z).reject


# -- the large makespan sampler -----------------------------------------

def test_makespan_trace_large_streams_and_agrees_with_the_model():
    P, K, t0, scale = 256, 300, 1.0, 0.5
    kw = dict(t0=t0, noise_scale=scale, trials=6, seed=9, device="cpu")
    T = makespan_trace_large(P, K, sync=True, chunk_k=64, batch=4, **kw)
    Tp = makespan_trace_large(P, K, sync=False, chunk_k=64, batch=4, **kw)
    assert T.shape == Tp.shape == (6,)
    # one seed, one stream: the same call repeats, and T' <= T holds
    # trial by trial because both makespans see the same draws
    assert torch.equal(T, makespan_trace_large(P, K, sync=True, chunk_k=64,
                                               batch=4, **kw))
    one = makespan_trace_large(P, K, sync=True, chunk_k=K, batch=6, **kw)
    assert float(one.mean()) == pytest.approx(float(T.mean()), rel=0.02)
    assert float(T.mean()) / K == pytest.approx(
        t0 + scale * harmonic(P), rel=0.02)
    assert (Tp <= T).all() and (Tp >= K * t0).all()
    speedup = float(T.mean()) / float(Tp.mean())
    assert 1.0 < speedup < (t0 + scale * harmonic(P)) / t0


# -- the examples ------------------------------------------------------------

@pytest.mark.parametrize("script,args", [
    ("quickstart_torch.py", ["--cpu", "--n", "512"]),
    ("stochastic_analysis_torch.py", ["--cpu"])])
def test_examples_run_on_the_cpu(script, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = ["--out", str(tmp_path)] if "stochastic" in script else []
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args, *extra], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "device=cpu" in out.stdout
    if "stochastic" in script:
        assert sorted(p.name for p in tmp_path.glob("ecdf_*.csv")) == [
            f"ecdf_{a.lower()}.csv" for a in sorted(TABLE1)]
