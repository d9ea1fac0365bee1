"""The port's solver-as-a-service layer against the JAX package's, on the CPU.

Both servers get the same numpy operator and b (``convert.dia_from_numpy``)
at the reference tests' sizes (N = 64, K = 4 slots, B = 4 iterations a
block, maxiter 200, tol 1e-10; n = 96 for warm reuse).  The JAX side runs
``engine="naive"`` (its fused engine reaches a Pallas kernel that cannot
run here: ROADMAP H1); the port runs ``engine="fused"`` on the plain
versions of its kernels, and ``"naive"``.

Tolerances:
- the M/G/k functions, ``simulate_batch_queue`` and the closed-form
  arrival processes are host numpy copies: equal bit for bit;
- ``trace:<ALG>`` arrivals draw the trace with a torch generator, so
  they are held by their long-run rate (10%), as the reference's test is;
- ``laplacian_mode_rhs`` sums its sine modes in torch: 1e-14 of the
  largest entry (``sin`` differs from numpy's by an ulp);
- burst records: ``iters`` and the block indices exactly, x to 1e-10 of
  ``max |x|`` (H6: the two packages sum their dots in different orders;
  no case here lands a column on the other side of its tolerance, so no
  +-1-iteration case arises);
- the three properties (no starvation, admission independence, retire
  equivalence) hold within the port bit for bit, on fixed seeds
  (hypothesis is absent here).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.perfmodel.queueing as jq
from repro.core.krylov.operators import tridiagonal_laplacian as jax_laplacian
from repro.serve import ServeChaos as JaxChaos
from repro.serve import SolverServer as JaxServer
from repro.serve import arrival_times as jax_arrivals
from repro.serve import laplacian_mode_rhs as jax_mode_rhs
from repro.serve import request as jreq
from repro.serve import synthetic_requests as jax_requests
from repro_torch.convert import dia_from_numpy
from repro_torch.core.krylov.cg import _pipecg_scalars
from repro_torch.core.krylov.operators import tridiagonal_laplacian
from repro_torch.core.krylov.options import SolverOptions
from repro_torch.core.perfmodel import queueing as q
from repro_torch.serve import (ContinuousBatcher, RequestQueue, ServeChaos,
                               SolveRequest, SolverServer, arrival_times,
                               content_key, group_key, laplacian_mode_rhs,
                               operator_fingerprint, synthetic_requests)
from repro_torch.serve.batcher import clear_compile_cache

N = 64          # operator size of the property runs
K = 4           # batch slots
B = 4           # iterations per batch step
MAXITER = 200
CPU = "cpu"


def _operator(n=N):
    JA = jax_laplacian(n)
    return JA, dia_from_numpy(JA.offsets, np.asarray(JA.bands), device=CPU)


def _requests(seed, n_reqs, *, deadlines=None, n=N):
    A = tridiagonal_laplacian(n, device=CPU)
    reqs = synthetic_requests(A, n_reqs, tol=1e-10, maxiter=MAXITER,
                              modes=(4, 24), seed=seed)
    if deadlines is not None:
        for r, d in zip(reqs, deadlines):
            r.deadline_s = float(d)
    return reqs


def _pair(seed, n_reqs):
    """The reference's requests, and the port's over the same numpy b."""
    JA, A = _operator()
    jreqs = jax_requests(JA, n_reqs, tol=1e-10, maxiter=MAXITER,
                         modes=(4, 24), seed=seed)
    preqs = [SolveRequest(rid=r.rid, A=A, b=np.asarray(r.b), tol=r.tol,
                          maxiter=r.maxiter) for r in jreqs]
    return jreqs, preqs


def _serve(reqs, *, k_slots=K, chaos=None, engine="fused", server=None):
    srv = (server or SolverServer)(k_slots=k_slots, engine=engine,
                                   step_block=B, chaos=chaos)
    srv.warmup(reqs[0])
    srv.submit_all(reqs)
    stats = srv.run()
    return srv, stats


# -- the M/G/k model -----------------------------------------------------------

def test_quantile_key_and_erlang_c_match_the_reference():
    for v in (0.5, 0.9, 0.99, 0.999, 0.25, 0.9999):
        assert q.quantile_key(v) == jq.quantile_key(v)
    for k in (1, 2, 4, 8, 16):
        for a in (0.0, 0.3, 0.5 * k, 0.9 * k, 0.999 * k, k, 2.0 * k):
            assert q.erlang_c(k, a) == jq.erlang_c(k, a)
    with pytest.raises(ValueError):
        q.erlang_c(0, 1.0)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("rho", [0.3, 0.7, 0.95])
@pytest.mark.parametrize("cv", [0.0, 0.5, 1.5])
def test_queue_model_is_the_reference_bit_for_bit(k, rho, cv):
    rng = np.random.default_rng(k * 100 + int(rho * 10))
    mean = 0.02
    if cv == 0.0:
        service = np.full(257, mean)
    else:
        s2 = math.log(1.0 + cv * cv)
        service = rng.lognormal(math.log(mean) - s2 / 2, math.sqrt(s2), 257)
    lam = rho * k / float(np.mean(service))
    got = q.QueueModel(lam=lam, service=service, k=k)
    want = jq.QueueModel(lam=lam, service=service, k=k)
    for attr in ("es", "cv2", "rho"):
        assert getattr(got, attr) == getattr(want, attr)
    assert got.mean_wait() == want.mean_wait()
    t = np.linspace(0.0, 0.5, 11)
    assert np.array_equal(got.wait_tail(t), want.wait_tail(t))
    assert got.sojourn_quantiles() == want.sojourn_quantiles()
    assert (q.predicted_sojourn_quantiles(lam, service, k, qs=(0.5, 0.9))
            == jq.predicted_sojourn_quantiles(lam, service, k,
                                              qs=(0.5, 0.9)))


@pytest.mark.parametrize("policy", ["edf", "fifo"])
def test_simulate_batch_queue_is_the_reference_bit_for_bit(policy):
    rng = np.random.default_rng(3)
    n = 400
    arr = np.cumsum(rng.exponential(0.01, n))
    dem = rng.integers(5, 60, n)
    ddl = rng.uniform(0.05, 1.0, n)
    got = q.simulate_batch_queue(arr, dem, 1e-3, 4, step_block=8,
                                 policy=policy, deadlines_s=ddl)
    want = jq.simulate_batch_queue(arr, dem, 1e-3, 4, step_block=8,
                                   policy=policy, deadlines_s=ddl)
    assert set(got) == set(want)
    for key in got:
        assert np.array_equal(got[key], want[key]), key


# -- load generation -----------------------------------------------------------

@pytest.mark.parametrize("name", ["poisson", "uniform", "lognormal"])
def test_closed_form_arrivals_are_the_reference_bit_for_bit(name):
    got = arrival_times(name, 3000, rate=40.0, seed=7, device=CPU)
    want = jax_arrivals(name, 3000, rate=40.0, seed=7)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="positive"):
        arrival_times(name, 3, rate=0.0, device=CPU)


def test_trace_arrivals_hit_the_target_rate():
    t = arrival_times("trace:PIPECG", 4000, rate=50.0, seed=0, device=CPU)
    assert t.shape == (4000,) and np.all(np.diff(t) >= 0)
    assert 4000 / t[-1] == pytest.approx(50.0, rel=0.1)
    ref = jax_arrivals("trace:PIPECG", 4000, rate=50.0, seed=0)
    assert 4000 / t[-1] == pytest.approx(4000 / ref[-1], rel=0.1)


@pytest.mark.parametrize("n,m", [(64, 4), (257, 40), (1000, 256)])
def test_mode_rhs_matches_the_reference(n, m):
    got = laplacian_mode_rhs(n, m, np.random.default_rng(n + m), device=CPU)
    want = jax_mode_rhs(n, m, np.random.default_rng(n + m))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("modes", [None, (4, 24)])
def test_synthetic_requests_draw_the_reference_sequence(modes):
    JA, A = _operator(96)
    arr = np.linspace(0.0, 1.0, 5)
    got = synthetic_requests(A, 5, tol=1e-9, maxiter=77, modes=modes,
                             arrival=arr, seed=11)
    want = jax_requests(JA, 5, tol=1e-9, maxiter=77, modes=modes,
                        arrival=arr, seed=11)
    for g, w in zip(got, want):
        assert (g.rid, g.tol, g.maxiter, g.arrival_s) == \
            (w.rid, w.tol, w.maxiter, w.arrival_s)
        wb = np.asarray(w.b)
        if modes is None:   # the dense branch stays host numpy, bit for bit
            assert isinstance(g.b, np.ndarray) and np.array_equal(g.b, wb)
        else:
            assert isinstance(g.b, torch.Tensor)
            np.testing.assert_allclose(g.b.numpy(), wb, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="one entry per request"):
        synthetic_requests(A, 2, arrival=[0.0], seed=0)


# -- keys and the fingerprint memo --------------------------------------------

def test_keys_and_fingerprints_equal_the_reference():
    JA, A = _operator()
    b = np.random.default_rng(0).standard_normal(N)
    jr = jreq.SolveRequest(rid=0, A=JA, b=b)
    for pb in (b, torch.from_numpy(b)):
        pr = SolveRequest(rid=0, A=A, b=pb)
        assert group_key(pr) == jreq.group_key(jr)
        assert operator_fingerprint(A) == jreq.operator_fingerprint(JA)
        assert content_key(pr) == jreq.content_key(jr)
    f32 = SolveRequest(rid=1, A=A, b=torch.zeros(N, dtype=torch.float32))
    assert group_key(f32)[2] == "float32"
    scaled = dia_from_numpy(JA.offsets, 1.5 * np.asarray(JA.bands),
                            device=CPU)
    assert operator_fingerprint(scaled) != operator_fingerprint(A)


def test_fingerprint_is_taken_once_per_operator(monkeypatch):
    _, A = _operator()
    calls = []
    real = type(A).fingerprint

    def counting(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(type(A), "fingerprint", counting)
    reqs = [SolveRequest(rid=i, A=A, b=np.ones(N)) for i in range(6)]
    queue = RequestQueue()
    for r in reqs:
        queue.push(r)
    key = queue.peek_group()
    assert queue.group_sizes() == {key: 6}
    assert [queue.pop_compatible(key).rid for _ in range(6)] == list(range(6))
    assert len(calls) == 1
    first = operator_fingerprint(A)
    A.bands[1, 3] += 1.0      # an in-place write re-takes the digest
    assert operator_fingerprint(A) != first and len(calls) == 2


# -- the batch step ------------------------------------------------------------

def test_per_column_first_flag_matches_the_batch_flag_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    st = {key: torch.rand(5, generator=g, dtype=torch.float64) + 0.5
          for key in ("gamma", "delta", "gamma_prev", "alpha_prev")}
    for flag in (True, False):
        want = _pipecg_scalars(st, flag)
        got = _pipecg_scalars(st, torch.full((5,), flag))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    mixed = torch.tensor([True, False, True, False, False])
    alpha, beta = _pipecg_scalars(st, mixed)
    on, off = _pipecg_scalars(st, True), _pipecg_scalars(st, False)
    assert torch.equal(alpha, torch.where(mixed, on[0], off[0]))
    assert torch.equal(beta, torch.where(mixed, on[1], off[1]))


@pytest.mark.parametrize("engine", ["fused", "naive"])
def test_burst_records_match_the_reference(engine):
    jreqs, preqs = _pair(0, 2 * K)
    jsrv, jstats = _serve(jreqs, engine="naive", server=JaxServer)
    srv, stats = _serve(preqs, engine=engine)
    assert stats.drained and stats.n_converged == jstats.n_converged == 2 * K
    assert srv.blocks == jsrv.blocks
    assert srv.per_block_active == jsrv.per_block_active
    want = {r.rid: r for r in jsrv.records}
    assert [r.rid for r in srv.records] == [r.rid for r in jsrv.records]
    for got in srv.records:
        ref = want[got.rid]
        assert (got.iters, got.arrival_block, got.admitted_block,
                got.finished_block, got.restarts, got.converged) == \
            (ref.iters, ref.arrival_block, ref.admitted_block,
             ref.finished_block, ref.restarts, ref.converged)
        xr = np.asarray(ref.x)
        assert np.max(np.abs(got.x - xr)) <= 1e-10 * np.max(np.abs(xr))
    assert srv.run_counts["blocks"] == srv.blocks
    assert srv.run_counts["admissions"] == 2 * K
    assert srv.run_counts["batcher_inits"] == 0   # warmup built it
    assert sum(srv.run_counts["launches"].values()) == 0   # CPU: plain


def _check_no_starvation(seed):
    rng = np.random.default_rng(seed)
    n_reqs = 3 * K
    deadlines = rng.uniform(0.5, 5.0, n_reqs)
    reqs = _requests(seed, n_reqs, deadlines=deadlines)
    srv, stats = _serve(reqs)
    assert stats.drained and stats.n_converged == n_reqs
    order = sorted(reqs, key=lambda r: (r.arrival_s + r.deadline_s, r.rid))
    rank = {r.rid: i for i, r in enumerate(order)}
    blocks_per_solve = math.ceil(MAXITER / B)
    for rec in srv.records:
        e = rank[rec.rid]
        bound = math.ceil((e + K) / K) * blocks_per_solve
        waited = rec.admitted_block - rec.arrival_block
        assert waited <= bound, (rec.rid, waited, bound)


def _check_admission_independence(seed, engine):
    A = tridiagonal_laplacian(N, device=CPU)
    reqs = _requests(seed, 2)
    solo = ContinuousBatcher(A, K, engine=engine, step_block=B)
    both = ContinuousBatcher(A, K, engine=engine, step_block=B)
    solo.admit(0, reqs[0])
    both.admit(0, reqs[0])
    solo.step()
    both.step()
    both.admit(1, reqs[1])  # mid-flight admission into a free column
    both.poison(2)          # NaN in a free column touches no other one
    for _ in range(3):
        solo.step()
        both.step()
    for leaf in solo.state["vecs"]:
        a = solo.state["vecs"][leaf][0]
        b = both.state["vecs"][leaf][0]
        assert torch.equal(a, b), leaf
    assert both.state["iters"][0] == solo.state["iters"][0]


def _check_retire_equivalence(seed):
    n_reqs = 2 * K
    reqs = _requests(seed, n_reqs)
    srv, stats = _serve(reqs)
    assert stats.drained and stats.n_converged == n_reqs
    batched = {r.rid: r for r in srv.records}
    for req in reqs[:3]:
        solo_srv, _ = _serve([_requests(seed, n_reqs)[req.rid]])
        solo = solo_srv.records[0]
        got = batched[req.rid]
        assert solo.iters == got.iters, req.rid
        assert np.array_equal(solo.x, got.x), req.rid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_no_starvation_past_deadline_bound(seed):
    _check_no_starvation(seed)


@pytest.mark.parametrize("engine", ["fused", "naive"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_never_perturbs_in_flight_columns(seed, engine):
    _check_admission_independence(seed, engine)


@pytest.mark.parametrize("seed", [0, 1])
def test_retired_column_matches_solo_run(seed):
    _check_retire_equivalence(seed)


def test_queue_is_edf_within_groups():
    reqs = _requests(0, 4, deadlines=[3.0, 1.0, 2.0, 1.0])
    queue = RequestQueue()
    for r in reqs:
        queue.push(r)
    key = queue.peek_group()
    order = [queue.pop_compatible(key).rid for _ in range(4)]
    assert order == [1, 3, 2, 0]  # deadline, ties by arrival order
    assert len(queue) == 0 and queue.peek() is None
    assert queue.pop_urgent() is None and queue.peek_group() is None


def test_warm_reuse_shares_the_cache_entry():
    """A second same-family operator (other bands) reuses every built
    callable: the build counts stay at their cold values."""
    clear_compile_cache()
    n = 96  # unique shape: no other test warms this key
    A = tridiagonal_laplacian(n, device=CPU)
    reqs = synthetic_requests(A, 2, tol=1e-8, maxiter=200, modes=(4, 16),
                              seed=3)
    srv1, stats1 = _serve([reqs[0]], k_slots=2)
    (batcher1,) = srv1.batchers.values()
    cold = dict(batcher1.trace_counts)
    assert cold == {"step": 1, "init": 2, "admit": 1}
    A2 = dataclasses.replace(A, bands=A.bands * 1.5)
    reqs2 = synthetic_requests(A2, 1, tol=1e-8, maxiter=200, modes=(4, 16),
                               seed=4)
    srv2, stats2 = _serve(reqs2, k_slots=2)
    (batcher2,) = srv2.batchers.values()
    assert batcher2.compiled is batcher1.compiled
    assert dict(batcher2.trace_counts) == cold
    assert stats1.n_converged == 1 and stats2.n_converged == 1


def test_chaos_restarts_like_the_reference():
    """A killed column restarts from scratch and a corrupted one is caught
    by the exit checks; both converge, with the reference's events and
    per-request restarts and iteration counts."""
    jreqs, preqs = _pair(7, K)
    lane = ["kill:0@1", "corrupt:1@2"]
    jchaos, chaos = JaxChaos(lane), ServeChaos(lane)
    jsrv, _ = _serve(jreqs, chaos=jchaos, engine="naive", server=JaxServer)
    srv, stats = _serve(preqs, chaos=chaos)
    assert stats.drained and stats.n_converged == len(preqs)
    assert stats.restarts >= 2
    assert [(e.kind, e.shard, e.at_iter) for e in chaos.events] == \
        [(e.kind, e.shard, e.at_iter) for e in jchaos.events]
    want = {r.rid: r for r in jsrv.records}
    for rec in srv.records:
        ref = want[rec.rid]
        assert (rec.restarts, rec.iters, rec.finished_block) == \
            (ref.restarts, ref.iters, ref.finished_block)
        b = preqs[rec.rid].b
        assert rec.res_norm <= preqs[rec.rid].tol * np.linalg.norm(b) * 1.01
    assert srv.run_counts["admissions"] == len(preqs) + stats.restarts
    confirmed = [d for d in srv.detections if d.confirmed]
    assert confirmed and all(d.action == "quarantine" for d in confirmed)
    assert len(srv.detections) == len(jsrv.detections)


def test_clean_run_reports_no_detection():
    srv, stats = _serve(_requests(5, 2 * K))
    assert stats.n_converged == 2 * K and stats.restarts == 0
    assert srv.detections == []


def test_corrupt_is_quarantined_and_confirmed():
    reqs = _requests(2, K)
    chaos = ServeChaos(["corrupt:2@1"])
    srv, stats = _serve(reqs, chaos=chaos)
    assert stats.n_converged == K and stats.restarts == 1
    (d,) = srv.detections
    assert (d.detector, d.action, d.confirmed, d.tripped) == \
        ("state_deviation", "quarantine", True, True)
    assert [e.kind for e in chaos.events] == ["corrupt"]


def test_stall_stretches_blocks_without_touching_the_numbers():
    reqs = _requests(4, K)
    clean, _ = _serve([dataclasses.replace(r) for r in reqs])
    chaos = ServeChaos(["stall:0@1"])
    srv, stats = _serve(reqs, chaos=chaos)
    assert stats.restarts == 0 and srv.detections == []
    for a, b in zip(srv.records, clean.records):
        assert a.iters == b.iters and np.array_equal(a.x, b.x)


# -- options -------------------------------------------------------------------

def test_solve_request_options_unpack():
    _, A = _operator()
    b = np.ones(N)
    req = SolveRequest(rid=0, A=A, b=b,
                       options=SolverOptions(maxiter=200, tol=1e-8))
    assert (req.maxiter, req.tol) == (200, 1e-8)
    with pytest.raises(TypeError, match="not both"):
        SolveRequest(rid=1, A=A, b=b, tol=1e-6, options=SolverOptions())
    with pytest.raises(ValueError, match="server-level"):
        SolveRequest(rid=2, A=A, b=b, options=SolverOptions(engine="fused"))
    with pytest.raises(ValueError, match="precision"):
        SolveRequest(rid=3, A=A, b=b,
                     options=SolverOptions(precision="bf16"))
    with pytest.raises(ValueError, match="depth"):
        SolveRequest(rid=4, A=A, b=b, options=SolverOptions(depth=2))
    with pytest.raises(TypeError, match="SolverOptions"):
        SolveRequest(rid=5, A=A, b=b, options={"tol": 1e-8})
    with pytest.raises(ValueError, match="callable"):
        SolveRequest(rid=6, A=A, b=b, M=lambda r: r)
    with pytest.raises(ValueError, match="ip must be"):
        SolveRequest(rid=7, A=A, b=b, ip="B")


def test_solver_server_options():
    assert SolverServer().engine == "fused"
    assert SolverServer(options=SolverOptions(engine="naive")).engine == \
        "naive"
    assert SolverServer(options=SolverOptions()).engine == "fused"
    with pytest.raises(TypeError, match="not both"):
        SolverServer(engine="fused", options=SolverOptions(engine="fused"))
    with pytest.raises(ValueError, match="per-request"):
        SolverServer(options=SolverOptions(maxiter=50))
    with pytest.raises(ValueError, match="chaos"):
        SolverServer(options=SolverOptions(noise=object()))
    with pytest.raises(ValueError, match="rr"):
        SolverServer(options=SolverOptions(rr=5))


# -- the campaign's serve stage ------------------------------------------------

def test_serve_exec_smoke_schema():
    """A tiny end-to-end serve_exec run keeps the reference's record
    schema (its own validator reads it) minus ``autotune_stats``."""
    from repro.experiments.validation import validate_serve_cells
    from repro_torch.experiments import CampaignSpec, get_preset
    from repro_torch.experiments.serve_exec import (bench_record, jsonable,
                                                    run_serve_exec)

    assert get_preset("smoke").serve_engine == "fused"
    spec = CampaignSpec(name="serve-test", serve_requests=8, serve_n=96,
                        serve_modes=(8, 48), serve_tol=1e-8,
                        serve_maxiter=300, serve_k_slots=4,
                        serve_step_block=8, serve_rho=0.5,
                        serve_replay_requests=512, seed=5)
    serve = run_serve_exec(spec, device=CPU)
    assert {key for key in serve if not key.startswith("_")} == {
        "burst", "accuracy", "paced", "trace_counts"}
    assert set(serve["_servers"]) == {"batched", "sequential", "paced",
                                      "burst_requests", "paced_requests"}
    assert set(jsonable(serve)) == {"burst", "accuracy", "paced",
                                    "trace_counts"}
    v = validate_serve_cells(serve)
    assert v["drained"] and v["all_converged"] and v["accuracy_ok"]
    assert all(c["bitwise"] for c in serve["accuracy"])
    assert math.isfinite(v["p50_rel_err"]) and math.isfinite(v["p99_rel_err"])
    rec = bench_record(serve)
    (burst_key,) = [k for k in rec["serve"] if k.startswith("burst")]
    assert {"throughput_speedup", "p50_s", "p99_s", "p999_s",
            "drained", "accuracy_ok"} <= set(rec["serve"][burst_key])
    (paced_key,) = [k for k in rec["serve"] if k.startswith("paced")]
    assert {"p50_rel_err", "p99_rel_err", "model_ok"} <= set(
        rec["serve"][paced_key])
    counts = serve["burst"]["run_counts"]["batched"]
    assert counts["admissions"] == 8 and counts["blocks"] > 0
    assert jsonable({"a": np.float64(np.inf), "_x": 1}) == {"a": "inf"}
