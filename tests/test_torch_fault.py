"""Faults, checkpoints, the resync model and elastic recovery of the port,
against the JAX package on the same inputs.

In-process pieces, each against its JAX counterpart: ``analyze_step_times``
and ``pipelining_benefit`` over tests/test_fault.py's edge cases (bit for
bit); ``make_fault`` parsing and rejections; ``FaultInjector`` ticks,
waits, events, ``dead_shards`` and ``step_time_matrix`` under one
schedule and seed; every ``resync`` function (1e-12); ``first_trip`` and
``merge_reports``; the ``CheckpointManager`` round trip, retention,
``latest_step`` and the three error-surfacing cases of test_fault.py, and
checkpoints read across packages.

Elastic solves, at 4 gloo ranks (one spawn for every case) against the JAX package's
``resilient_distributed_solve`` on 4 forced host devices with its halo
sweep replaced by the kernel's arithmetic in jnp (one subprocess,
tests/jax_slice_reference.py, H1), on test_elastic.py's operator
(``tridiagonal_laplacian(240)`` + 1 on the diagonal): the carried
hand-off 4 -> 2 (10 + 30 iterations) equals the straight 40 to 1e-10;
an ``x0=`` restart; an undisturbed solve; ``kill:1@14``;
``kill:1@14`` + ``kill:3@26``; ``corrupt:2@8``; ``stall:0@5`` (no
ambient noise, ``stall_s=1e-3``: the detector reads recorded waits, not
wall time); a clean bf16 segment loop, whose checksum must not trip
(H9); and two rollbacks that follow a segment accepted without a rank,
``stall:0@5`` + ``corrupt:2@25`` and ``kill:1@14`` + ``kill:3@32``
(every process, the evicted and the dead ones too, passes the restore's
barrier).  test_elastic.py's assertions hold, and each case's recovery events
and iteration counts equal the JAX run's, x to 1e-8 relative.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_slice_reference as R
import repro.core.krylov.abft as jabft
import repro.core.noise.faults as jfaults
import repro.core.perfmodel as jpm
import repro.distributed.fault as jfault
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.krylov import abft
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.noise import (FAULT_KINDS, FaultInjector, FaultSpec,
                                    make_fault, make_faults)
import repro_torch.core.perfmodel as pm
from repro_torch.distributed import fault, ranks

# -- analyze_step_times / pipelining_benefit ---------------------------------

TRACES = {
    "empty": np.zeros((0, 4)),
    "all-zero": np.zeros((50, 4)),
    "single-step": np.array([[1.0, 2.0, 1.0, 1.0]]),
    "single-process": np.full((30, 1), 7.0),
    "straggler": np.concatenate([np.ones((100, 2)), np.full((100, 1), 5.0),
                                 np.ones((100, 1))], axis=1),
    "noisy": np.random.default_rng(0).exponential(1.0, (200, 8)),
}


def _outcome(fn, *args):
    """``fn``'s result, or the type of what it raised (an all-zero trace
    divides 0 by 0 in both packages)."""
    try:
        return fn(*args)
    except Exception as e:   # noqa: BLE001 - compared, not swallowed
        return type(e)


@pytest.mark.parametrize("name", list(TRACES))
def test_analyze_step_times_equals_the_reference(name):
    t = TRACES[name]
    for cost in (200.0, 10.0):
        got = fault.analyze_step_times(t, restart_cost_steps=cost)
        want = jfault.analyze_step_times(t, restart_cost_steps=cost)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _outcome(fault.pipelining_benefit, t) == \
        _outcome(jfault.pipelining_benefit, t)
    assert fault.analyze_step_times(TRACES["straggler"],
                                    restart_cost_steps=10.0
                                    ).persistent_outlier == 2


def test_make_fault_parsing_and_rejections():
    f = make_fault("kill:1@10")
    assert (f.kind, f.shard, f.at_iter) == ("kill", 1, 10)
    assert make_fault("stall:0@5", stall_s=0.25).stall_s == 0.25
    assert make_fault("corrupt:2@8", magnitude=42.0).magnitude == 42.0
    assert [f.kind for f in make_faults(["kill:0@1", "stall:1@2"])] == [
        "kill", "stall"]
    for name in ("kill:1@10", "stall:0@5", "corrupt:2@8"):
        assert dataclasses.asdict(make_fault(name)) == dataclasses.asdict(
            jfaults.make_fault(name))
    with pytest.raises(ValueError, match="unknown fault kind"):
        make_fault("melt:1@10")
    with pytest.raises(ValueError, match="cannot parse"):
        make_fault("kill-1-10")
    with pytest.raises(ValueError, match="cannot parse"):
        make_fault("kill:x@10")
    with pytest.raises(ValueError):
        FaultSpec(kind="kill", shard=-1, at_iter=0)
    with pytest.raises(ValueError, match="only 2 logical shards"):
        FaultInjector(faults=[make_fault("kill:3@1")], n_shards=2)
    assert FAULT_KINDS == jfaults.FAULT_KINDS == ("kill", "stall", "corrupt")


def _drive(inj, script):
    """Ticks of a call script: ints call that rank, tuples set the mesh,
    'pause'/'resume' toggle."""
    ticks = []
    for step in script:
        if step == "pause":
            inj.pause()
        elif step == "resume":
            inj.resume()
        elif isinstance(step, tuple):
            inj.set_mesh(step)
        else:
            ticks.append(float(inj(step)))
    return ticks


SCRIPTS = {
    "kill": (["kill:1@3"], {}, 2, [0, 1] * 6),
    "corrupt": (["corrupt:0@2"], dict(magnitude=9.0), 1, [0] * 5),
    "stall": (["stall:1@2"], dict(stall_s=1e-4), 2, [0, 1] * 6),
    "pause-mesh": (["kill:2@0"], {}, 3,
                   ["pause", 2, "resume", (0, 2), 1, 0, 1]),
    "noisy-stall": (["stall:1@0"], dict(stall_s=1e-6), 2, [1, 0] * 40),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_injector_sequences_equal_the_reference(name):
    from repro.core.perfmodel.distributions import Exponential as JExp
    faults, kw, shards, script = SCRIPTS[name]
    noisy = name == "noisy-stall"
    mine = FaultInjector(dist=pm.Exponential(1.0) if noisy else None,
                         scale=1e-6, seed=7, faults=make_faults(faults, **kw),
                         n_shards=shards)
    theirs = jfaults.FaultInjector(
        dist=JExp(1.0) if noisy else None, scale=1e-6, seed=7,
        faults=jfaults.make_faults(faults, **kw), n_shards=shards)
    got, want = _drive(mine, script), _drive(theirs, script)
    np.testing.assert_array_equal(got, want)
    assert mine.dead_shards == theirs.dead_shards
    assert [dataclasses.astuple(e) for e in mine.events] == \
        [dataclasses.astuple(e) for e in theirs.events]
    assert mine.iter_count == theirs.iter_count
    for s in range(shards):
        np.testing.assert_array_equal(mine.shard_waits(s),
                                      theirs.shard_waits(s))
    for start in (0, 3):
        np.testing.assert_array_equal(mine.step_time_matrix(start),
                                      theirs.step_time_matrix(start))
    if name == "kill":
        assert np.isnan(got[-1]) and mine.dead_shards == {1}
    if name == "corrupt":
        assert got == [0.0, 0.0, 9.0, 0.0, 0.0]


def test_resync_functions_equal_the_reference():
    close = dict(rel=1e-12, abs=0.0)
    for p in (1, 5, 20):
        assert pm.detection_iters(p) == jpm.detection_iters(p)
        for mag, thr in ((1e3, 1.0), (0.5, 1.0)):
            assert pm.abft_detection_iters(mag, thr, p) == \
                jpm.abft_detection_iters(mag, thr, p)
        for kind in pm.FAULT_RECOVERY_KINDS:
            for l, s in ((1, 1), (2, 2), (4, 1)):
                assert pm.recovery_overhead_bound(kind, p, l=l, s_sync=s) \
                    == jpm.recovery_overhead_bound(kind, p, l=l, s_sync=s)
    assert pm.FAULT_RECOVERY_KINDS == jpm.FAULT_RECOVERY_KINDS
    for K, eps, tau in ((1000, 1e-16, 1e3), (50, 2.0 ** -8, 10.0)):
        assert pm.adaptive_rr_replacements(K, eps, tau) == pytest.approx(
            jpm.adaptive_rr_replacements(K, eps, tau), **close)
        assert pm.adaptive_rr_overhead_iters(K, eps, tau, l=2, s_sync=3) \
            == pytest.approx(jpm.adaptive_rr_overhead_iters(
                K, eps, tau, l=2, s_sync=3), **close)
    for dist, jdist in ((None, None),
                        (pm.Exponential(1.0), jpm.Exponential(1.0)),
                        (pm.Uniform(0.5, 1.5), jpm.Uniform(0.5, 1.5))):
        for l in (1, 4):
            kw = dict(t0=1.0, red_latency=2.0, l=l, trials=500, seed=3)
            assert pm.resync_iter_time(dist, 4, device="cpu", **kw) == \
                pytest.approx(jpm.resync_iter_time(jdist, 4, **kw), **close)
            assert pm.expected_fault_makespan(
                dist, 4, 100, 0.05, 10, reshard_cost=5.0, kind="corrupt",
                device="cpu", **kw) == pytest.approx(
                jpm.expected_fault_makespan(jdist, 4, 100, 0.05, 10,
                                            reshard_cost=5.0,
                                            kind="corrupt", **kw), **close)
    for cost, lam in ((2.0, 0.01), (8.0, 0.04), (2.0, 0.0)):
        assert pm.optimal_checkpoint_period(cost, lam) == \
            jpm.optimal_checkpoint_period(cost, lam)
    for bad in (lambda m: m.detection_iters(0),
                lambda m: m.recovery_overhead_bound("melt", 10),
                lambda m: m.recovery_overhead_bound("kill", 10, l=0),
                lambda m: m.optimal_checkpoint_period(-1.0, 0.01),
                lambda m: m.expected_fault_makespan(None, 4, 100, -0.1, 10),
                lambda m: m.resync_iter_time(None, 0)):
        for mod in (pm, jpm):
            with pytest.raises(ValueError):
                bad(mod)


def test_first_trip_and_merge_reports():
    for values, thr in (([0.0, 1e-3, 5.0, 1.0], 1.0), ([0.1, 0.2], 1.0),
                        ([0.0, np.nan, 0.0], 1.0), ([], 1.0)):
        assert abft.first_trip(values, thr) == jabft.first_trip(values, thr)
    assert [f.name for f in dataclasses.fields(abft.DetectionReport)] == \
        [f.name for f in dataclasses.fields(jabft.DetectionReport)]
    assert [f.default for f in dataclasses.fields(abft.DetectionReport)] == \
        [f.default for f in dataclasses.fields(jabft.DetectionReport)]
    spec = [("checksum", True, 7, True), ("history_jump", True, 3, None),
            ("deviation", False, -1, None)]
    mine = [abft.DetectionReport(solver="pipecg", detector=d, tripped=t,
                                 trip_iter=i, confirmed=c)
            for d, t, i, c in spec]
    theirs = [jabft.DetectionReport(solver="pipecg", detector=d, tripped=t,
                                    trip_iter=i, confirmed=c)
              for d, t, i, c in spec]
    assert abft.merge_reports(mine) == jabft.merge_reports(theirs)
    assert abft.merge_reports([]) == jabft.merge_reports([])


# -- CheckpointManager ---------------------------------------------------

def test_checkpoint_roundtrip_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep=2, async_write=True)
    assert mgr.latest_step() is None
    state = {"x": torch.arange(6, dtype=torch.float64).reshape(2, 3),
             "u": torch.ones(3, dtype=torch.bfloat16),
             "done": torch.tensor([True, False]),
             "nested": [torch.zeros(2, dtype=torch.int32)]}
    for step in (1, 2, 3):
        mgr.save(step, {**state, "x": state["x"] * step},
                 extra={"productive": 10 * step})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_0000000002", "step_0000000003"]
    got, manifest = mgr.restore(state)
    assert manifest["step"] == 3 and manifest["productive"] == 30
    assert torch.equal(got["x"], state["x"] * 3)
    assert got["u"].dtype == torch.bfloat16 and torch.equal(got["u"],
                                                            state["u"])
    assert got["done"].dtype == torch.bool
    assert torch.equal(got["nested"][0], state["nested"][0])
    old, _ = mgr.restore(state, step=2)
    assert torch.equal(old["x"], state["x"] * 2)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_checkpoint_async_write_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=True)
    mgr.save(1, {"x": torch.ones(4)})
    mgr.wait()
    assert mgr.latest_step() == 1
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    good_dir, mgr.dir = mgr.dir, blocker
    mgr.save(2, {"x": torch.ones(4)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.dir = good_dir
    mgr.save(3, {"x": torch.zeros(4)})
    mgr.wait()
    assert mgr.latest_step() == 3


def test_checkpoint_async_write_error_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=True)
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    good_dir, mgr.dir = mgr.dir, blocker
    mgr.save(1, {"x": torch.ones(2)})
    mgr._q.join()
    mgr.dir = good_dir
    with pytest.raises(OSError):
        mgr.save(2, {"x": torch.ones(2)})
    mgr.save(2, {"x": torch.ones(2)})     # raised exactly once
    mgr.wait()
    assert mgr.latest_step() == 2


def test_checkpoint_sync_write_error_raises_immediately(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_write=False)
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    mgr.dir = blocker
    with pytest.raises(OSError):
        mgr.save(1, {"x": torch.ones(2)})


def test_checkpoints_read_across_packages(tmp_path):
    arrays = {"x": np.arange(12.0).reshape(3, 4),
              "gamma_prev": np.array([0.5, 2.0]),
              "done": np.array([True, False])}
    JCheckpointManager(tmp_path / "j", async_write=False).save(
        4, {k: jnp.asarray(v) for k, v in arrays.items()},
        extra={"productive": 40})
    template = {k: torch.from_numpy(np.zeros_like(v))
                for k, v in arrays.items()}
    got, man = CheckpointManager(tmp_path / "j").restore(template)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert man["productive"] == 40 and man["step"] == 4
    CheckpointManager(tmp_path / "t", async_write=False).save(
        5, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
        extra={"productive": 50})
    jgot, jman = JCheckpointManager(tmp_path / "t").restore(
        {k: np.zeros_like(v) for k, v in arrays.items()})
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jgot[k]), v)
    drop = ("time",)
    assert {k: v for k, v in jman.items() if k not in drop} == \
        {k: v for k, v in json_manifest(tmp_path / "t", 5).items()
         if k not in drop}
    assert jman["bytes"] == man["bytes"] == sum(
        v.nbytes for v in arrays.values())


def json_manifest(d, step):
    import json
    return json.loads((d / f"step_{step:010d}" / "manifest.json")
                      .read_text())


# -- elastic solves at 4 ranks -------------------------------------------

KW = dict(tol=1e-10, checkpoint_period=10)
ELASTIC = [
    dict(name="undisturbed", maxiter=120),
    dict(name="kill", maxiter=120, faults=["kill:1@14"], seed=3),
    dict(name="double-kill", maxiter=160, faults=["kill:1@14", "kill:3@26"],
         seed=5),
    dict(name="corrupt", maxiter=120, faults=["corrupt:2@8"], seed=2),
    dict(name="stall", maxiter=120, faults=["stall:0@5"],
         fault_kw=dict(stall_s=1e-3)),
    dict(name="bf16", maxiter=120, precision="bf16"),
    # rollbacks after a segment accepted without a rank: the rank outside
    # the survivors must still join the restore's barrier
    dict(name="stall-corrupt", maxiter=120,
         faults=["stall:0@5", "corrupt:2@25"], fault_kw=dict(stall_s=1e-3)),
    dict(name="late-double-kill", maxiter=160,
         faults=["kill:1@14", "kill:3@32"], seed=5),
]


def _port_elastic_cases():
    offs, bands, b = R.elastic_problem()
    A = DiaMatrix(offsets=offs, bands=torch.from_numpy(bands.copy()))
    b = torch.from_numpy(b.copy())
    out = []
    for c in ELASTIC:
        out.append(dict(A=A, b=b, faults=c.get("faults"),
                        fault_kw=c.get("fault_kw", {}),
                        seed=c.get("seed", 0), policy=c.get("precision"),
                        kw=dict(maxiter=c["maxiter"], **KW)))
    return out


def _warm_cases(rank, world):
    """Rank body: the carried hand-off 4 -> 2 and the x0 restart."""
    import torch.distributed as dist
    from repro_torch.core.krylov import distributed_solve, pipecg

    offs, bands, b = R.elastic_problem()
    A = DiaMatrix(offsets=offs, bands=torch.from_numpy(bands.copy()))
    b = torch.from_numpy(b.copy())
    kw = dict(engine="sharded_fused", tol=0.0)
    straight = distributed_solve(pipecg, A, b, maxiter=40, **kw)
    first, state = distributed_solve(pipecg, A, b, maxiter=10,
                                     with_state=True, **kw)
    pair = dist.new_group(ranks=[0, 1])
    second = None
    if rank < 2:
        second = distributed_solve(pipecg, A, b, pair, maxiter=30,
                                   carried=state, **kw)
    x0 = distributed_solve(pipecg, A, b, maxiter=15,
                           x0=torch.from_numpy(R.x0_of(b.shape[0])), **kw)

    def np_(res):
        return None if res is None else {
            k: (None if v is None else v.numpy())
            for k, v in res._asdict().items()}

    return dict(straight=np_(straight), first=np_(first), second=np_(second),
                state={k: v.double().numpy() for k, v in state.items()},
                x0=np_(x0))


def _rank_cases(rank, world, cases):
    """Rank body: the resilient cases, then the warm-start cases."""
    return (fault.resilient_cases(rank, world, cases, "cpu"),
            _warm_cases(rank, world))


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elastic") / "ref.pkl")
    cfg = dict(devices=4, n=16, seed=0, out=out, wire=[],
               elastic=[dict(c, **KW, period=KW["checkpoint_period"])
                        for c in ELASTIC] + [dict(name="handoff"),
                                             dict(name="x0")])
    for c in cfg["elastic"]:
        c.pop("checkpoint_period", None)
    proc = R.start(cfg)
    try:
        both = ranks.run(_rank_cases, 4, _port_elastic_cases(),
                         device="cpu")
        port, warm = [p for p, _ in both], [w for _, w in both]
    except BaseException:
        proc.kill()
        raise
    return port, warm, R.finish(proc, out)


def _case(elastic, name):
    port, _, ref = elastic
    i = [c["name"] for c in ELASTIC].index(name)
    return [r[i] for r in port], ref[f"elastic/{name}"]


def test_carried_handoff_equals_the_straight_solve(elastic):
    _, warm, ref = elastic
    for rank, w in enumerate(warm):
        xs = w["straight"]["x"]
        if rank < 2:
            x2 = w["second"]["x"]
            assert np.linalg.norm(x2 - xs) / np.linalg.norm(xs) < 1e-10
            assert abs(float(w["second"]["res_norm"])
                       - float(w["straight"]["res_norm"])) < 1e-10
        else:
            assert w["second"] is None
        # the state is global, the JAX package's own, to rounding
        for k, v in ref["elastic/handoff/state"].items():
            np.testing.assert_allclose(w["state"][k], np.asarray(
                v, np.float64), rtol=1e-10, atol=1e-12)
    xr = ref["elastic/handoff/second"]["x"]
    np.testing.assert_allclose(warm[0]["second"]["x"], xr, rtol=0,
                               atol=1e-10 * np.abs(xr).max())


def test_x0_restart_matches_the_reference(elastic):
    _, warm, ref = elastic
    want = ref["elastic/x0"]
    for w in warm:
        np.testing.assert_allclose(w["x0"]["res_history"],
                                   want["res_history"], rtol=1e-10)
        np.testing.assert_allclose(w["x0"]["x"], want["x"], rtol=0,
                                   atol=1e-10 * np.abs(want["x"]).max())


REPORT_KEYS = ("converged", "productive_iters", "executed_iters", "segments",
               "n_shards_final", "recoveries")


@pytest.mark.parametrize("name", [c["name"] for c in ELASTIC])
def test_resilient_solve_matches_the_reference_run(elastic, name):
    got, want = _case(elastic, name)
    for rank_out in got:
        rep, wrep = rank_out["report"], want["report"]
        for key in REPORT_KEYS:
            assert rep[key] == wrep[key], (key, rep[key], wrep[key])
        xw = want["result"]["x"]
        assert np.linalg.norm(rank_out["x"] - xw) / np.linalg.norm(xw) \
            < 1e-8
        assert [d["detector"] for d in rep["detections"]] == \
            [d["detector"] for d in wrep["detections"]]
        assert rep == got[0]["report"]        # every rank returns the same


def test_elastic_assertions_of_the_reference(elastic):
    """tests/test_elastic.py's and test_fault.py's assertions."""
    rep0 = _case(elastic, "undisturbed")[0][0]["report"]
    assert rep0["converged"] and not rep0["recoveries"]
    rep = _case(elastic, "kill")[0][0]["report"]
    assert rep["converged"] and rep["n_shards_final"] == 3
    assert [e["kind"] for e in rep["recoveries"]] == ["kill"]
    assert rep["recoveries"][0]["mode"] == "rollback_restart"
    assert rep["true_res_norm"] <= 10 * max(rep0["true_res_norm"], 1e-12)
    rep = _case(elastic, "double-kill")[0][0]["report"]
    assert rep["converged"] and rep["n_shards_final"] == 2
    assert sorted(e["kind"] for e in rep["recoveries"]) == ["kill", "kill"]
    assert rep["true_res_norm"] < 1e-8
    rep = _case(elastic, "corrupt")[0][0]["report"]
    assert rep["converged"]
    assert [e["kind"] for e in rep["recoveries"]] == ["corrupt"]
    assert rep["recoveries"][0]["mode"] == "rollback_restart"
    assert rep["recoveries"][0]["detector"] in ("checksum", "history_jump")
    assert rep["executed_iters"] > rep0["executed_iters"]
    rep = _case(elastic, "stall")[0][0]["report"]
    assert rep["converged"] and rep["n_shards_final"] == 3
    assert [(e["kind"], e["mode"], e["shard"]) for e in rep["recoveries"]] \
        == [("stall", "evict_continue", 0)]
    rep = _case(elastic, "stall-corrupt")[0][0]["report"]
    assert rep["converged"] and rep["n_shards_final"] == 3
    assert [(e["kind"], e["shard"]) for e in rep["recoveries"]] == [
        ("stall", 0), ("corrupt", 2)]
    rep = _case(elastic, "late-double-kill")[0][0]["report"]
    assert rep["converged"] and rep["n_shards_final"] == 2
    assert [(e["kind"], e["shard"]) for e in rep["recoveries"]] == [
        ("kill", 1), ("kill", 3)]
    assert rep["true_res_norm"] < 1e-8
    # H9: a clean bf16 loop never trips the checksum detector
    rep = _case(elastic, "bf16")[0][0]["report"]
    assert rep["converged"] and not rep["recoveries"]
    assert not rep["detections"]
