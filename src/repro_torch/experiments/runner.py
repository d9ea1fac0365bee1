"""Campaign execution stages (the JAX package's ``experiments/runner.py``).

Three measurement paths, in increasing realism:

1. ``measured_makespans`` — discrete-event Monte Carlo over per-iteration
   waiting times: T = sum_k max_p T_p^k (synchronized, Eq. 6) versus
   T' = max_p sum_k T_p^k (pipelined, Eq. 7), streamed over iterations so
   Piz-Daint-scale (P=8192, K=5000) cells never materialize (trials, K, P).
   This part, with the s-sync and lag-l variants, is host numpy drawing
   through ``sample_np``, so on the closed-form noises it equals the JAX
   package's cells bit for bit.
2. ``run_engine_exec`` / ``run_depth_exec`` — real solves per iteration
   engine on ``device`` (the card unless the caller asks for the CPU):
   per-iteration wall time, recurrence residual, TRUE residual
   ``||b - A x||`` and their drift (Cools-style residual-replacement
   diagnostics).  The ``sharded_fused`` cells run on ``n_shards`` spawned
   ranks (``distributed/ranks.py``), all of them in one spawn; the JAX
   package runs them on a mesh of its local devices.
3. The noisy execution (:func:`noisy_jobs`, :func:`noisy_record`) — real
   many-rank solves through ``distributed_solve(..., noise=NoiseHook(...))``
   on ``n_shards`` spawned ranks: every iteration stalls for a sampled
   wait, giving measured run-time samples whose distribution the fitting
   stage must recover (the round-trip check).

Every many-rank cell is a :class:`RankJob`; :func:`start_rank_jobs`
runs a list of them, one spawn per world size, and the stage functions
turn the outputs into records.  The ranks start at once but run no job
until the caller's host work is done, so that no measured time is taken
beside it.

All times in seconds unless a field name says otherwise.  The ranks'
kernel launches live in their own processes: ``RankJobs.result`` adds
them, by stage, to the ``launches`` it is given.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.perfmodel.distributions import Distribution
from repro_torch.experiments.noise_sources import sample_np

# cap on the (trials * iters * P) block materialized per sampling chunk
_CHUNK_BUDGET = 4_000_000


@dataclasses.dataclass
class MakespanMeasurement:
    """One (noise, P) discrete-event cell.

    ``t_sync`` / ``t_pipe``: per-trial makespans (trials,), in the
    distribution's time unit; ``waits``: recorded per-(iteration, process)
    wait samples for the fitting stage; ``trials_effective``: trials after
    large-P scaling.
    """

    t_sync: np.ndarray
    t_pipe: np.ndarray
    waits: np.ndarray
    iters: int
    P: int
    trials_effective: int

    @property
    def speedup(self) -> float:
        """Measured pipelined speedup: mean(T) / mean(T')."""
        return float(self.t_sync.mean() / self.t_pipe.mean())


def effective_trials(trials: int, P: int) -> int:
    """Scale the trial count down at very large P (memory/time bound)."""
    return max(16, trials // max(1, P // 256))


def measured_makespans(dist: Distribution, P: int, iters: int, trials: int,
                       seed: int = 0, t0_sync: float = 0.0,
                       t0_pipe: float = 0.0, fit_samples: int = 2000
                       ) -> MakespanMeasurement:
    """Monte-Carlo measure both makespans under iid per-step waits.

    Per trial: iteration times are ``t0 + W`` with ``W ~ dist`` iid over
    (iteration, process).  ``t0_sync`` / ``t0_pipe`` add a deterministic
    per-iteration compute base (0 = the paper's pure-waiting-time regime in
    which the asymptotic model E[max]/mu is exact as K -> inf).

    Streams over iterations in chunks so memory stays bounded at any
    (trials, iters, P).
    """
    trials = effective_trials(trials, P)
    rng = np.random.default_rng(seed)
    chunk = max(1, _CHUNK_BUDGET // max(trials * P, 1))
    acc_sync = np.zeros(trials)
    acc_proc = np.zeros((trials, P))
    waits: Optional[np.ndarray] = None
    done = 0
    while done < iters:
        kb = min(chunk, iters - done)
        w = sample_np(dist, rng, (trials, kb, P))
        if waits is None:
            waits = w[0].reshape(-1)[:fit_samples].copy()
        acc_sync += (t0_sync + w).max(axis=2).sum(axis=1)
        acc_proc += (t0_pipe + w).sum(axis=1)
        done += kb
    return MakespanMeasurement(t_sync=acc_sync, t_pipe=acc_proc.max(axis=1),
                               waits=waits, iters=iters, P=P,
                               trials_effective=trials)


@dataclasses.dataclass
class SyncMeasurement:
    """One (noise, P, s) s-sync discrete-event cell.

    ``t_sync`` / ``t_pipe``: mean s-sync synchronized / fused-overlapped
    makespans (the distribution's time unit, with ``red_latency`` per
    sync point on the synchronized side); ``speedup`` their ratio.
    """

    t_sync: float
    t_pipe: float
    iters: int
    P: int
    s: int
    red_latency: float
    trials_effective: int

    @property
    def speedup(self) -> float:
        """Measured s-sync speedup mean(T) / mean(T')."""
        return self.t_sync / self.t_pipe


def measured_s_sync_makespans(dist: Distribution, P: int, iters: int,
                              trials: int, s: int, red_latency: float,
                              seed: int = 0) -> SyncMeasurement:
    """Simulate the s-sync makespans of ``core/perfmodel/sync.py``.

    Synchronized: the iteration splits into ``s`` segments, each ending
    in a blocking reduction — ``T = sum_k sum_j [max_p W_p^{k,j} + R]``
    with per-segment waits ``W/s`` (so the total per-iteration wait mass
    matches the one-sync grid).  Pipelined: the s reductions are fused
    into ONE overlapped collective, so each process pays
    ``max(sum_j W^{k,j}, R)`` per iteration and the makespan is the max
    over processes of the per-process sums.  Streams the waiting-time
    draws in chunks like :func:`measured_makespans`.
    """
    trials = effective_trials(trials, P)
    rng = np.random.default_rng(seed)
    chunk = max(1, _CHUNK_BUDGET // max(trials * P * s, 1))
    acc_sync = np.zeros(trials)
    acc_proc = np.zeros((trials, P))
    done = 0
    while done < iters:
        kb = min(chunk, iters - done)
        w = sample_np(dist, rng, (trials, kb, s, P)) / s
        acc_sync += w.max(axis=3).sum(axis=(1, 2)) + kb * s * red_latency
        acc_proc += np.maximum(w.sum(axis=2), red_latency).sum(axis=1)
        done += kb
    return SyncMeasurement(t_sync=float(acc_sync.mean()),
                           t_pipe=float(acc_proc.max(axis=1).mean()),
                           iters=iters, P=P, s=s,
                           red_latency=red_latency,
                           trials_effective=trials)


@dataclasses.dataclass
class DepthMeasurement:
    """One (noise, P, l) lag-l discrete-event cell.

    ``t_sync`` / ``t_pipe``: mean synchronized / lag-l makespans (the
    distribution's time unit + ``red_latency`` per step on the sync
    side); ``speedup`` their ratio.
    """

    t_sync: float
    t_pipe: float
    iters: int
    P: int
    l: int
    red_latency: float
    trials_effective: int

    @property
    def speedup(self) -> float:
        """Measured depth-l speedup mean(T) / mean(T_l)."""
        return self.t_sync / self.t_pipe


def measured_depth_makespans(dist: Distribution, P: int, iters: int,
                             trials: int, l: int, red_latency: float,
                             seed: int = 0) -> DepthMeasurement:
    """Simulate the lag-l synchronization makespan (perfmodel/depth.py).

    Synchronized baseline: ``T = sum_k [max_p W_p^k + R]`` (Eq. 6 with
    the reduction latency R on every step's critical path).  Depth-l:
    the lag-l recursion ``T_p(k) = max(T_p(k-1), S(k-l) + R) + W_p^k``
    with ``S(j) = max_p T_p(j)`` — a process runs at most l steps ahead
    of the reduction pipeline; l -> inf recovers Eq. 7.  Streams the
    waiting-time draws in chunks like :func:`measured_makespans`.
    """
    trials = effective_trials(trials, P)
    rng = np.random.default_rng(seed)
    chunk = max(1, _CHUNK_BUDGET // max(trials * P, 1))
    T = np.zeros((trials, P))
    Sbuf = np.zeros((trials, l))   # ring buffer: S(k-1) ... S(k-l)
    t_sync = np.zeros(trials)
    k = 0
    done = 0
    while done < iters:
        kb = min(chunk, iters - done)
        w = sample_np(dist, rng, (trials, kb, P))
        t_sync += w.max(axis=2).sum(axis=1) + kb * red_latency
        for j in range(kb):
            if k >= l:   # slot k % l holds S(k-l), about to be overwritten
                gate = Sbuf[:, k % l] + red_latency
                T = np.maximum(T, gate[:, None]) + w[:, j, :]
            else:
                T = T + w[:, j, :]
            Sbuf[:, k % l] = T.max(axis=1)
            k += 1
        done += kb
    return DepthMeasurement(t_sync=float(t_sync.mean()),
                            t_pipe=float(T.max(axis=1).mean()),
                            iters=iters, P=P, l=l,
                            red_latency=red_latency,
                            trials_effective=trials)




# ---------------------------------------------------------------------------
# Rank jobs: every many-rank stage's cells, one spawn per world size
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankJob:
    """One stage's cells for ``world`` spawned ranks.

    ``body(rank, world, cfg, device)`` is a module-level function (the
    children import it) that runs the cells on the whole group and
    returns a dict with this rank's ``launches`` (its kernel launches,
    counted from 0 at the body's start).
    """

    stage: str
    world: int
    body: Callable
    cfg: Dict


def _jobs_rank_body(rank: int, world: int, jobs, device: str,
                    gate: str) -> List[Dict]:
    """Rank body of :func:`start_rank_jobs`: once the file ``gate``
    exists, the jobs in order, each between barriers, with its wall
    seconds."""
    import torch.distributed as dist

    while not os.path.exists(gate):
        time.sleep(0.01)
    out = []
    for body, cfg in jobs:
        dist.barrier()
        t0 = time.perf_counter()
        res = body(rank, world, cfg, device)
        dist.barrier()
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def _tally(into: Optional[Dict], stage: str, values: Dict) -> None:
    if into is not None:
        mine = into.setdefault(stage, {})
        for k, v in values.items():
            mine[k] = mine.get(k, 0) + v


class RankJobs:
    """Rank jobs started by :func:`start_rank_jobs`: the first world
    size's ranks start at once and wait for :meth:`result` before their
    first job; the other world sizes, one spawn each, run in it too."""

    def __init__(self, jobs: Sequence[RankJob], device):
        from repro_torch.distributed import ranks

        self.jobs, self.device = list(jobs), device
        self.worlds = list(dict.fromkeys(j.world for j in self.jobs))
        self._dir = tempfile.TemporaryDirectory(prefix="repro_torch_gate_")
        self.gate = os.path.join(self._dir.name, "go")
        try:
            self.first = (ranks.start(_jobs_rank_body, self.worlds[0],
                                      self._bodies(self.worlds[0]),
                                      str(device), self.gate, device=device)
                          if self.worlds else None)
        except BaseException:
            self._dir.cleanup()
            raise

    def cancel(self) -> None:
        """Stop the running spawn (a caller that will not wait for it)."""
        try:
            if self.first is not None:
                self.first.cancel()
        finally:
            self._dir.cleanup()

    def _bodies(self, world: int):
        return [(j.body, j.cfg) for j in self.jobs if j.world == world]

    def result(self, launches: Optional[Dict[str, Dict[str, int]]] = None,
               seconds: Optional[Dict[str, float]] = None
               ) -> List[List[Dict]]:
        """Each job's per-rank outputs, in job order; ``launches[stage]``
        and ``seconds[stage]``, when given, add each job's kernel launches
        (summed over its ranks) and wall seconds (rank 0's, between
        barriers)."""
        from repro_torch.distributed import ranks

        open(self.gate, "w").close()     # the ranks' jobs run now
        results: List[Optional[List[Dict]]] = [None] * len(self.jobs)
        try:
            for w, world in enumerate(self.worlds):
                outs = (self.first.result() if w == 0 else
                        ranks.run(_jobs_rank_body, world,
                                  self._bodies(world), str(self.device),
                                  self.gate, device=self.device))
                idx = [i for i, j in enumerate(self.jobs)
                       if j.world == world]
                _collect(self.jobs, idx, outs, results, launches, seconds)
        finally:
            self._dir.cleanup()
        return results


def start_rank_jobs(jobs: Sequence[RankJob], device="cuda") -> RankJobs:
    """Start ``jobs`` on spawned ranks (``distributed/ranks.py``) on
    ``device`` and return at once: one spawn per world size with every
    job of that size in it, in order.  The first world's ranks start now,
    so that their start-up runs beside the caller's host work, and wait
    for ``result()`` before their first job: no job, and no time a job
    measures, shares the host with that work."""
    return RankJobs(jobs, device)


def run_rank_jobs(jobs: Sequence[RankJob], device="cuda",
                  launches: Optional[Dict[str, Dict[str, int]]] = None,
                  seconds: Optional[Dict[str, float]] = None
                  ) -> List[List[Dict]]:
    """Run ``jobs`` on spawned ranks and wait: :func:`start_rank_jobs`,
    then its ``result(launches, seconds)``."""
    return start_rank_jobs(jobs, device).result(launches, seconds)


def _collect(jobs, idx, outs, results, launches, seconds) -> None:
    """File the outputs of one spawn's jobs ``idx`` under their stages."""
    for k, i in enumerate(idx):
        per_rank = [o[k] for o in outs]
        results[i] = per_rank
        total: Dict[str, int] = {}
        for r in per_rank:
            for name, v in r["launches"].items():
                total[name] = total.get(name, 0) + int(v)
        _tally(launches, jobs[i].stage, total)
        if seconds is not None:
            seconds[jobs[i].stage] = (seconds.get(jobs[i].stage, 0.0)
                                      + per_rank[0]["seconds"])


# ---------------------------------------------------------------------------
# Real solver execution
# ---------------------------------------------------------------------------

# solvers the sharded_fused engine can express (distributed_solve dispatch)
_SHARDED_SOLVERS = ("pipecg", "pipecr", "pipebicgstab")


def _solver_fn(name: str):
    from repro_torch.core import krylov
    if name not in ("cg", "cr", "pipecg", "pipecr", "gmres", "pgmres",
                    "pipecg_l", "pgmres_l", "bicgstab", "pipebicgstab"):
        raise KeyError(name)
    return getattr(krylov, name)


def _true_residual(A, b, x) -> float:
    r = b - A.matvec(x)
    return float(torch.sqrt(torch.sum(r * r)))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_per_iter(solve, repeats: int, maxiter: int, device):
    """One warm call, then ``repeats`` timed ones: (last result, seconds
    per iteration)."""
    out = solve()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = solve()
    _sync(device)
    return out, (time.perf_counter() - t0) / repeats / maxiter


def _exec_cell(A, b, bnorm, out, per_iter, **keys) -> Dict:
    res_rec = float(out.res_norm)
    res_true = _true_residual(A, b, out.x)
    return {**keys, "per_iter_us": per_iter * 1e6,
            "res_recurrence": res_rec, "res_true": res_true,
            "drift_rel": abs(res_true - res_rec) / bnorm}


def _ex23(n: int, device):
    from repro_torch.core.krylov import tridiagonal_laplacian
    A = tridiagonal_laplacian(n, device=device)
    b = torch.ones((n,), dtype=A.dtype, device=device)
    return A, b, float(torch.sqrt(torch.sum(b * b)))


def engine_rank_cells(rank: int, world: int, cfg: Dict,
                      device: str = "cuda") -> Dict:
    """Rank body of the sharded engine cells: every solver of ``cfg`` on
    this group, timed between barriers (the slowest rank's time); rank
    0's cells and this rank's kernel launches."""
    import torch.distributed as dist

    from repro_torch.core.krylov import distributed_solve
    from repro_torch.kernels import ops

    n, maxiter, repeats = cfg["n"], cfg["maxiter"], cfg["repeats"]
    A, b, bnorm = _ex23(n, device)
    ops.reset_launch_counts()
    cells = []
    for solver in cfg["solvers"]:
        fn = _solver_fn(solver)

        def solve(fn=fn):
            return distributed_solve(fn, A, b, None, engine="sharded_fused",
                                     maxiter=maxiter)
        dist.barrier()
        out, per_iter = _timed_per_iter(solve, repeats, maxiter, device)
        t = torch.tensor([per_iter], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        cells.append(_exec_cell(A, b, bnorm, out, float(t[0]),
                                solver=solver, engine="sharded_fused", n=n,
                                maxiter=maxiter, n_shards=world))
    return {"cells": cells if rank == 0 else [],
            "launches": ops.launch_counts()}


def _engine_grid(solvers, engines, n: int, n_shards: int):
    """The (solver, engine) cells in the reference's order, and the
    solvers of its sharded cells."""
    order, sharded = [], []
    for solver in solvers:
        for engine in engines:
            if engine == "sharded_fused":
                if solver not in _SHARDED_SOLVERS or n % n_shards:
                    continue
                sharded.append(solver)
            order.append((solver, engine))
    return order, sharded


def engine_jobs(solvers: Tuple[str, ...], engines: Tuple[str, ...], n: int,
                maxiter: int, repeats: int = 3, n_shards: int = 4
                ) -> List[RankJob]:
    """The rank job of :func:`run_engine_exec`'s sharded cells (none when
    there are none)."""
    _, sharded = _engine_grid(solvers, engines, n, n_shards)
    if not sharded:
        return []
    return [RankJob("engine", n_shards, engine_rank_cells,
                    {"n": n, "maxiter": maxiter, "repeats": repeats,
                     "solvers": sharded})]


def run_engine_exec(solvers: Tuple[str, ...], engines: Tuple[str, ...],
                    n: int, maxiter: int, repeats: int = 3, *,
                    device="cuda", n_shards: int = 4,
                    sharded_outs: Sequence[List[Dict]] = ()
                    ) -> List[Dict]:
    """Time real solves per (solver, engine) and report residual drift.

    Returns one dict per cell with ``per_iter_us`` (wall microseconds per
    iteration), ``res_recurrence`` (the solver's recurrence residual),
    ``res_true`` (recomputed ``||b - A x||``) and ``drift_rel``
    (|true - recurrence| / ||b||) — the Cools-style true-residual gap that
    pipelined rearrangements are known to widen.

    ``engine="sharded_fused"`` cells run through ``distributed_solve`` on
    ``n_shards`` spawned ranks (halo-aware single-sweep kernel +
    split-phase all-reduce), all in the one job of :func:`engine_jobs`,
    whose per-rank outputs (:func:`run_rank_jobs`) the caller passes as
    ``sharded_outs``; they carry an extra ``n_shards`` key.
    Solver/engine combinations an engine cannot express are skipped.  The
    other cells run in this process on ``device``.
    """
    order, _ = _engine_grid(solvers, engines, n, n_shards)
    by_solver = ({c["solver"]: c for c in sharded_outs[0][0]["cells"]}
                 if sharded_outs else {})
    A, b, bnorm = _ex23(n, device)
    cells = []
    for solver, engine in order:
        if engine == "sharded_fused":
            cells.append(by_solver[solver])
            continue
        fn = _solver_fn(solver)
        out, per_iter = _timed_per_iter(
            lambda fn=fn, engine=engine: fn(A, b, maxiter=maxiter,
                                            engine=engine),
            repeats, maxiter, device)
        cells.append(_exec_cell(A, b, bnorm, out, per_iter, solver=solver,
                                engine=engine, n=n, maxiter=maxiter))
    return cells


def run_depth_exec(depths: Tuple[int, ...], n: int, maxiter: int,
                   repeats: int = 3, engines: Tuple[str, ...] = ("fused",),
                   *, device="cuda") -> List[Dict]:
    """Time real depth-l solves (``pipecg_l``) and report residual drift.

    One cell per (l, engine): per-iteration wall time, recurrence vs
    TRUE residual, and ``drift_rel`` — the Cools-style accuracy cost of
    pushing the pipeline deeper (the ghost basis conditions like
    kappa^l, so drift growing with l is the expected, bounded behavior
    the depth tests pin down).
    """
    from repro_torch.core.krylov import pipecg_l

    A, b, bnorm = _ex23(n, device)
    cells = []
    for l in depths:
        for engine in engines:
            out, per_iter = _timed_per_iter(
                lambda l=l, engine=engine: pipecg_l(
                    A, b, l=l, maxiter=maxiter, engine=engine),
                repeats, maxiter, device)
            cells.append(_exec_cell(A, b, bnorm, out, per_iter,
                                    solver="pipecg_l", l=l, engine=engine,
                                    n=n, maxiter=maxiter))
    return cells


def noisy_rank_cells(rank: int, world: int, cfg: Dict,
                     device: str = "cuda") -> Dict:
    """Rank body of the noisy execution: per solver one hook, a warm solve
    and ``repeats`` timed ones; rank 0 gets every rank's injected waits,
    concatenated in rank order."""
    import torch.distributed as dist

    from repro_torch.core.krylov import distributed_solve
    from repro_torch.core.noise.injection import NoiseHook
    from repro_torch.kernels import ops

    n, maxiter = cfg["n"], cfg["maxiter"]
    A, b, _ = _ex23(n, device)
    ops.reset_launch_counts()
    cells = {}
    for si, solver in enumerate(cfg["solvers"]):
        fn = _solver_fn(solver)
        hook = NoiseHook(cfg["dist"], scale=cfg["noise_scale"],
                         seed=cfg["seed"] + 977 * si)

        def solve(fn=fn, hook=hook):
            dist.barrier()
            t0 = time.perf_counter()
            out = distributed_solve(fn, A, b, None, noise=hook,
                                    maxiter=maxiter)
            _sync(device)
            return out, time.perf_counter() - t0
        out, _ = solve()        # warm-up outside the timed runs
        times = []
        for _ in range(cfg["repeats"]):
            out, t = solve()
            times.append(t)
        # the group's run time is its slowest rank's
        t = torch.tensor(times, dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        waits = [None] * world
        dist.all_gather_object(waits, hook.shard_waits(rank))
        cells[solver] = {
            "run_times": t.numpy(),
            "injected_waits": np.concatenate(waits),
            "res_norm": float(out.res_norm),
            "res_true": _true_residual(A, b, out.x),
            "n": n, "maxiter": maxiter,
        }
    return {"cells": cells if rank == 0 else {},
            "launches": ops.launch_counts()}


def noisy_jobs(solvers: Tuple[str, ...], dist: Distribution,
               noise_scale: float, n: int, maxiter: int, repeats: int,
               seed: int = 0, n_shards: int = 4) -> List[RankJob]:
    """The rank job of the noisy execution (:func:`noisy_rank_cells`)."""
    return [RankJob("noisy", n_shards, noisy_rank_cells,
                    {"n": n, "maxiter": maxiter, "repeats": repeats,
                     "solvers": list(solvers), "dist": dist,
                     "noise_scale": noise_scale, "seed": seed})]


def noisy_record(outs: List[List[Dict]]) -> Dict[str, Dict]:
    """The noisy execution's cells from its job's per-rank outputs.

    Repeated real many-rank solves with wall-clock noise injection: each
    solver ran through ``distributed_solve`` on the job's spawned ranks
    with a sleeping ``NoiseHook`` seeded ``seed + 977 * si`` on every
    rank.  The returned dict maps solver name to ``run_times`` (seconds,
    one per repeat, the slowest rank's), the injected waits of every rank
    (each rank's ``(seed, rank)`` substream, concatenated in rank order:
    the JAX package's multiset in another order), and the final
    residuals.  This is the campaign's rendering of the paper's n=12/n=20
    Piz Daint repeat sets.
    """
    return outs[0][0]["cells"]
