"""The port's stochastic performance model against the JAX reference.

Closed forms must agree exactly, quadrature to 1e-10.  Sampling is
``quantile(uniform)``: the quantiles are compared on the same uniforms,
and the sampled makespans, whose random streams differ, statistically.
"""
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
