"""The port's stochastic performance model against the JAX reference.

Closed forms must agree exactly, quadrature to 1e-10.  Sampling is
``quantile(uniform)``: the quantiles are compared on the same uniforms,
and the sampled makespans, whose random streams differ, statistically.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.perfmodel as jpm
import repro_torch.core.perfmodel as tpm

CPU = "cpu"

DISTS = [
    ("uniform", lambda m: m.Uniform(0.5, 2.0)),
    ("exponential", lambda m: m.Exponential(1.7)),
    ("lognormal", lambda m: m.LogNormal(0.2, 0.8)),
    ("gamma", lambda m: m.Gamma(2.5, 0.7)),
    ("pareto", lambda m: m.Pareto(1.2, 3.0)),
    ("shifted", lambda m: m.Shifted(m.Exponential(2.0), 0.3)),
]


@pytest.mark.parametrize("name,make", DISTS)
def test_distribution_functions_match(name, make):
    jd, td = make(jpm), make(tpm)
    u = np.random.default_rng(0).uniform(1e-6, 1 - 1e-6, 200)
    x = np.abs(np.random.default_rng(1).standard_normal(200)) * 2 + 0.01
    tu, tx = torch.from_numpy(u), torch.from_numpy(x)
    np.testing.assert_allclose(td.quantile(tu).numpy(),
                               np.asarray(jd.quantile(jnp.asarray(u))),
                               rtol=1e-12)
    np.testing.assert_allclose(td.cdf(tx).numpy(),
                               np.asarray(jd.cdf(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(td.pdf(tx).numpy(),
                               np.asarray(jd.pdf(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-14)
    assert td.mean == jd.mean
    assert td.name == jd.name


def test_deterministic_point_mass():
    jd, td = jpm.Deterministic(2.5), tpm.Deterministic(2.5)
    assert td.mean == jd.mean == 2.5
    gen = torch.Generator(device=CPU).manual_seed(0)
    assert torch.equal(td.sample(gen, (3, 4)),
                       torch.full((3, 4), 2.5, dtype=torch.float64))
    x = torch.tensor([1.0, 2.5, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(td.cdf(x).numpy(),
                                  np.asarray(jd.cdf(jnp.asarray(x.numpy()))))
    with pytest.raises(ValueError, match="density"):
        td.pdf(x)


@pytest.mark.parametrize("P", [2, 4, 64, 8192])
def test_closed_forms_exact(P):
    for name, make in DISTS[:2] + DISTS[5:]:
        assert tpm.expected_max_closed(make(tpm), P) == \
            jpm.expected_max_closed(make(jpm), P), name
        assert tpm.asymptotic_speedup(make(tpm), P) == \
            jpm.asymptotic_speedup(make(jpm), P), name
    assert tpm.harmonic(P) == jpm.harmonic(P)
    assert tpm.uniform_speedup(P) == jpm.uniform_speedup(P)
    assert tpm.exponential_speedup(P) == jpm.exponential_speedup(P)


def test_exponential_speedup_at_four_is_h4():
    s = tpm.asymptotic_speedup(tpm.Exponential(1.0), 4)
    assert s == jpm.asymptotic_speedup(jpm.Exponential(1.0), 4)
    assert s == pytest.approx(25 / 12, rel=1e-15)
    assert tpm.harmonic(2_000_000) == jpm.harmonic(2_000_000)


@pytest.mark.parametrize("P", [2, 4, 64, 8192])
@pytest.mark.parametrize("name", ["lognormal", "gamma", "pareto"])
def test_quadrature_matches(P, name):
    make = dict(DISTS)[name]
    want = jpm.asymptotic_speedup(make(jpm), P, method="quad")
    got = tpm.asymptotic_speedup(make(tpm), P, method="quad", device=CPU)
    assert got == pytest.approx(want, rel=1e-10)


def test_lognormal_paper_values():
    ln = tpm.LogNormal(0.0, 1.0)
    assert tpm.asymptotic_speedup(ln, 2, device=CPU) == pytest.approx(
        1.5205, abs=1e-4)
    assert tpm.asymptotic_speedup(ln, 4, device=CPU) == pytest.approx(
        2.2081, abs=1e-4)


def test_min_procs_and_tables_match():
    for name, make in DISTS[:3]:
        assert tpm.min_procs_exceeding(make(tpm), device=CPU) == \
            jpm.min_procs_exceeding(make(jpm)), name
    want = jpm.speedup_table(jpm.Exponential(1.0), [2, 8, 32])
    assert tpm.speedup_table(tpm.Exponential(1.0), [2, 8, 32],
                             device=CPU) == want
    assert tpm.single_delay_makespans(2.0, 0.5, 10) == \
        jpm.single_delay_makespans(2.0, 0.5, 10)


def test_expected_max_mc_near_closed_form():
    got = tpm.expected_max_mc(tpm.Exponential(1.0), 16, trials=40000,
                              seed=3, device=CPU)
    assert got == pytest.approx(tpm.harmonic(16), rel=0.02)
    with pytest.raises(ValueError, match="closed form"):
        tpm.expected_max(tpm.LogNormal(), 4, method="closed")


def test_simulate_statistically_matches_reference():
    """Different random streams: compare the makespans' means."""
    K, P, trials = 200, 8, 200
    want = jpm.simulate(jpm.Exponential(1.0), P=P, K=K, trials=trials)
    got = tpm.simulate(tpm.Exponential(1.0), P=P, K=K, trials=trials,
                       batch=64, device=CPU)
    assert tuple(got.t_sync.shape) == tuple(got.t_async.shape) == (trials,)
    assert got.t_sync.dtype == torch.float64
    # each synchronized step costs E[max of 8] = H_8 exactly
    assert float(got.t_sync.mean()) / K == pytest.approx(tpm.harmonic(P),
                                                         rel=0.01)
    assert got.speedup_of_means == pytest.approx(want.speedup_of_means,
                                                 rel=0.02)
    assert bool(torch.all(got.t_sync >= got.t_async))


def test_simulate_is_seeded_and_chunking_keeps_the_stream():
    d = tpm.Uniform(0.0, 1.0)
    a = tpm.simulate(d, P=4, K=10, trials=30, seed=5, batch=7, device=CPU)
    b = tpm.simulate(d, P=4, K=10, trials=30, seed=5, batch=7, device=CPU)
    c = tpm.simulate(d, P=4, K=10, trials=30, seed=6, batch=7, device=CPU)
    assert torch.equal(a.t_sync, b.t_sync)
    assert not torch.equal(a.t_sync, c.t_sync)
    curve = tpm.empirical_speedup_curve(d, 4, [5, 50], trials=64,
                                        device=CPU)
    assert set(curve) == {5, 50}


def test_model_defaults_to_the_card():
    """simulate without device= runs on the card; without one it raises."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        tpm.simulate(tpm.Exponential(1.0), P=2, K=2, trials=2)


# -- the s-sync model (core/perfmodel/sync.py) ----------------------------

@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("R", [0.0, 0.5, 2.0, 1e6])
def test_s_sync_speedup_matches_reference(s, R):
    """Same seed, same numpy draws: equal to the reference's float (to
    1e-10 where E[max] comes from quadrature, as the quadrature tests)."""
    for dist, rel in (("exponential", 1e-13), ("uniform", 1e-13),
                      ("lognormal", 1e-10)):
        mk = {"exponential": lambda m: m.Exponential(1.0),
              "uniform": lambda m: m.Uniform(0.0, 2.0),
              "lognormal": lambda m: m.LogNormal(0.0, 0.5)}[dist]
        want = jpm.s_sync_speedup(mk(jpm), 4, s, red_latency=R, t0=0.3,
                                  trials=4000, seed=5)
        got = tpm.s_sync_speedup(mk(tpm), 4, s, red_latency=R, t0=0.3,
                                 trials=4000, seed=5, device=CPU)
        assert got == pytest.approx(want, rel=rel)


def test_s_sync_table_ceiling_and_counts():
    d_j, d_t = jpm.Exponential(1.0), tpm.Exponential(1.0)
    want = jpm.s_sync_table(d_j, 4, (1, 2, 4), red_latency=2.0)
    got = tpm.s_sync_table(d_t, 4, (1, 2, 4), red_latency=2.0,
                           device=CPU)
    assert got.keys() == want.keys()
    for s in got:
        assert got[s] == pytest.approx(want[s], rel=1e-13)
    assert got[1] < got[2] < got[4] and got[4] > 2.0
    assert tpm.s_sync_ceiling(2) == jpm.s_sync_ceiling(2) == 2.0
    assert tpm.s_sync_ceiling(4) == jpm.s_sync_ceiling(4) == 4.0
    assert tpm.SOLVER_SYNC_COUNTS == jpm.SOLVER_SYNC_COUNTS
    assert tpm.s_sync_speedup(d_t, 4, 4, red_latency=1e6, device=CPU) \
        == pytest.approx(4.0, rel=1e-3)


# -- the depth-l model (core/perfmodel/depth.py) ---------------------------

DEPTH_DISTS = [("exponential", lambda m: m.Exponential(1.0), 1e-12),
               ("uniform", lambda m: m.Uniform(0.0, 2.0), 1e-12),
               ("lognormal", lambda m: m.LogNormal(0.0, 0.5), 1e-10)]


@pytest.mark.parametrize("l", [1, 2, 4, 8])
@pytest.mark.parametrize("name,make,rel", DEPTH_DISTS)
def test_depth_model_matches_reference(name, make, rel, l):
    """Same seed, same numpy draws: the block max, the modeled speedup and
    the ceiling equal the reference's floats (1e-10 where E[max] comes
    from quadrature)."""
    jd, td = make(jpm), make(tpm)
    kw = dict(red_latency=2.0, t0=0.3, trials=2000, seed=7)
    assert tpm.block_expected_max(td, 4, l, trials=2000, seed=7,
                                  device=CPU) == pytest.approx(
        jpm.block_expected_max(jd, 4, l, trials=2000, seed=7), rel=rel)
    assert tpm.modeled_depth_speedup(td, 4, l, device=CPU, **kw) == \
        pytest.approx(jpm.modeled_depth_speedup(jd, 4, l, **kw), rel=rel)
    assert tpm.depth_speedup_ceiling(td, 4, red_latency=2.0, t0=0.3,
                                     device=CPU) == pytest.approx(
        jpm.depth_speedup_ceiling(jd, 4, red_latency=2.0, t0=0.3), rel=rel)


def test_depth_table_crossover_and_bracket():
    """The reference's depth-model checks (tests/test_pipeline_depth.py):
    monotone in l, below the Eq. 8 ceiling, above 2 at depth; the table
    and the crossover depth equal the reference's."""
    d_j, d_t = jpm.Exponential(1.0), tpm.Exponential(1.0)
    want = jpm.depth_speedup_table(d_j, 4, (1, 2, 4, 8), red_latency=2.0,
                                   seed=7)
    got = tpm.depth_speedup_table(d_t, 4, (1, 2, 4, 8), red_latency=2.0,
                                  seed=7, device=CPU)
    assert got.keys() == want.keys()
    for l in got:
        assert got[l] == pytest.approx(want[l], rel=1e-12)
    ceiling = tpm.depth_speedup_ceiling(d_t, 4, red_latency=2.0, device=CPU)
    vals = [got[l] for l in sorted(got)]
    assert all(a <= b + 1e-9 for a, b in zip(vals, vals[1:]))
    assert vals[-1] <= ceiling * 1.02 and vals[-1] > 2.0
    for frac in (0.5, 0.9, 0.99):
        assert tpm.crossover_depth(got, ceiling, frac) == \
            jpm.crossover_depth(want, ceiling, frac)
    assert tpm.crossover_depth({1: 1.0}, 10.0) == -1
