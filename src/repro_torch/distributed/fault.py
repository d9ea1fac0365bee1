"""Fault tolerance and straggler handling: detector, advisor and actor.

Analysis: :func:`analyze_step_times` takes observed per-step times of P
processes and estimates the straggler penalty of synchronized execution
with the paper's makespan model, flagging a persistent straggler;
:func:`pipelining_benefit` is the empirical T / T' of a trace.

Recovery: :func:`resilient_distributed_solve` runs the sharded PIPECG
solve in segments of ``checkpoint_period`` iterations, detects kill,
corrupt and stall faults at segment boundaries and continues on the
surviving ranks.  It composes three pieces: the CheckpointManager (whole
host arrays, so any number of ranks can restore them), the warm start of
the sharded PIPECG body (``carried=`` exact continuation, ``x0=``
residual-replacement restart; core/krylov/distributed.py) and the NaN
tick of a killed shard (core/noise/faults.py).  Detection, boundary-
synchronous as a heartbeat timeout on the all-reduce would be:

  kill    -> the dead shard's NaN tick poisons the reduction within one
             iteration; the segment returns a non-finite residual norm
  corrupt -> the in-flight checksum row trips, or the residual history
             jumps, and the host true residual ||b - A x|| confirms
  stall   -> :func:`analyze_step_times` over the per-shard waits flags
             the persistent outlier

Process groups take the place of the JAX package's meshes: every process
of the world runs the controller in lockstep; a segment runs on the
group of the surviving ranks, and at each segment end the ranks gather
their injectors' records (the heartbeat), so each takes the same
decision from the same data.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.krylov import abft
from repro_torch.core.krylov.hostops import true_residual_norm
from repro_torch.core.noise.faults import FaultEvent, step_matrix


@dataclasses.dataclass
class StragglerReport:
    """Per-fleet straggler diagnosis from a (K, P) step-time trace."""

    p: int
    step_mean: float
    step_p99: float
    sync_overhead_frac: float     # (E[max_p] - mean) / mean
    persistent_outlier: Optional[int]
    recommend_restart: bool


def analyze_step_times(times: np.ndarray, *, restart_cost_steps: float = 200.0
                       ) -> StragglerReport:
    """times (K, P): per-step per-process durations.

    ``sync_overhead_frac`` is the paper's E[max]/mu - 1 estimated
    empirically; a persistent outlier is a process whose mean exceeds
    1.5x the fleet median (synchronized execution pays its full slowdown
    every step, Eq. 6), and a restart is recommended when the projected
    loss exceeds ``restart_cost_steps``.  Degenerate traces get a
    well-defined report: an empty or all-zero trace has no overhead and
    no outlier, a single step is its own p99, and one process has no
    fleet to be an outlier of.
    """
    times = np.asarray(times, np.float64)
    K, P = times.shape
    if K == 0 or P == 0:
        return StragglerReport(p=P, step_mean=0.0, step_p99=0.0,
                               sync_overhead_frac=0.0,
                               persistent_outlier=None,
                               recommend_restart=False)
    per_step_max = times.max(axis=1)
    mean = float(times.mean())
    # an all-zero trace observed no work, hence no overhead (not 0/0)
    overhead = (float(per_step_max.mean() / mean - 1.0) if mean > 0.0
                else 0.0)
    proc_means = times.mean(axis=0)
    p99 = float(np.quantile(times, 0.99))
    worst = int(np.argmax(proc_means))
    persistent = None
    if P > 1 and proc_means[worst] > 1.5 * float(np.median(proc_means)):
        persistent = worst
    projected_loss = overhead * K
    return StragglerReport(
        p=P, step_mean=mean, step_p99=p99,
        sync_overhead_frac=overhead,
        persistent_outlier=persistent,
        recommend_restart=bool(persistent is not None
                               and projected_loss > restart_cost_steps),
    )


def pipelining_benefit(times: np.ndarray) -> Dict[str, float]:
    """Empirical T/T' on an observed trace: the makespan interchange."""
    times = np.asarray(times, np.float64)
    t_sync = float(times.max(axis=1).sum())
    t_pipe = float(times.sum(axis=0).max())
    return {"t_sync": t_sync, "t_pipe": t_pipe, "speedup": t_sync / t_pipe}


@dataclasses.dataclass
class RecoveryEvent:
    """One detected fault and how the controller recovered from it.

    ``detect_iters`` is the detection latency in global iterations from
    the fault's onset to the iteration that surfaced it; ``iters_lost``
    the rolled-back work run again (zero for a stall eviction, which
    continues from the segment's own state); ``detector`` names the path
    that surfaced the fault.
    """

    kind: str                 # "kill" | "stall" | "corrupt"
    shard: int                # logical shard (-1 if unattributed)
    segment: int              # segment index at detection
    detect_iters: int
    iters_lost: int
    n_shards_after: int
    mode: str                 # "rollback_restart" | "evict_continue"
    detector: str = "true_residual"


@dataclasses.dataclass
class ResilientReport:
    """Outcome of a :func:`resilient_distributed_solve` run.

    ``productive_iters`` counts iterations of the surviving trajectory,
    ``executed_iters`` every iteration run, rolled-back work included;
    their difference (plus any convergence delay against an undisturbed
    solve) is the recovery overhead that perfmodel/resync.py bounds.
    """

    converged: bool
    res_norm: float
    true_res_norm: float
    productive_iters: int
    executed_iters: int
    segments: int
    n_shards_final: int
    recoveries: List[RecoveryEvent]
    wall_s: float
    segment_walls: List[float]
    detections: List["abft.DetectionReport"] = dataclasses.field(
        default_factory=list)


def _heartbeat(injector, me: int, seg_start: int) -> dict:
    """This process's injector record for the segment-end gather."""
    if injector is None:
        return {}
    return dict(dead=me in injector.dead_shards,
                count=injector.iter_count.get(me),
                events=[dataclasses.astuple(e) for e in injector.events],
                record=list(injector.shard_record.get(me, []))[seg_start:])


def _merge_events(beats) -> List[FaultEvent]:
    """Every rank's fired faults, in (iteration, shard) order."""
    seen = {tuple(e) for bt in beats for e in bt.get("events", ())}
    return [FaultEvent(*e) for e in sorted(seen, key=lambda e: (e[2], e[1]))]


def resilient_distributed_solve(
        A, b, group=None, *, solver=None, tol: float = 1e-10,
        maxiter: int = 400, checkpoint_period: int = 20,
        ckpt_dir: Optional[str] = None, injector=None, M=None,
        drift_factor: float = 1e3, jump_factor: float = 10.0,
        restart_cost_steps: float = 0.0, max_recoveries: int = 4,
        min_shards: int = 1, options=None):
    """Sharded PIPECG solve that survives shard faults mid-flight.

    Every process of the world calls it with the same ``A`` and ``b``;
    ``group`` (None: the world) names the logical shards, rank i of it
    being shard i, and must span every process, since a group of the
    survivors is made with ``torch.distributed.new_group``, which every
    process joins.  The solve runs ``distributed_solve(...,
    engine="sharded_fused")`` in segments of ``checkpoint_period``
    iterations on the group of the ranks still alive (``alive`` stays
    sorted, so its rank i is logical shard ``alive[i]``, the map
    ``injector.set_mesh`` takes).  After each segment the carried state
    ``{x, r, u, p, gamma_prev, alpha_prev, done}`` is checkpointed, once,
    by ``alive[0]``, and three detectors run, in this order:

    1. **kill**: a non-finite recurrence norm (a dead shard's NaN tick
       poisoned the reduction).  Drop the dead shards, restore the last
       checkpoint and RESTART on the survivors with ``x0=``: one
       synchronous ``r = b - A x``, the residual-replacement re-glue.
    2. **corrupt**: the checksum column of the segment trips
       (``abft.first_trip`` over ``abft.checksum_threshold``), or the
       residual history jumps ``jump_factor`` times up; one host
       ``||b - A x||`` confirms.  Roll back and restart on all shards.
    3. **stall**: :func:`analyze_step_times` on the shards' recorded waits
       flags a persistent straggler: evict it and continue exactly from
       the segment's own state.

    Each process's injector sees only its own shard, so at every segment
    end the ranks all-gather, over ``group``, their dead flag, fault
    events and waits since the segment began, and ``alive[0]`` adds the
    segment's norms: every rank decides from the same data.  Survivor
    groups are made by every process, in the same order, only when
    ``alive`` changes.  Before a restore every rank drains its writer and
    passes a barrier.  ``ckpt_dir=None`` makes a temporary directory on
    rank 0 (its path broadcast; removed at the end).  Returns
    ``(SolveResult, ResilientReport)``, broadcast from ``alive[0]``, so
    every rank, evicted and dead ones too, returns the same pair.

    ``options`` (a SolverOptions) bundles ``tol`` / ``maxiter`` / ``M`` /
    the precision policy; it cannot be mixed with the loose spellings,
    ``options.noise`` fills the ``injector=`` slot, ``options.maxiter``
    stays the total productive budget, ``engine`` must be the sharded
    path, ``depth`` 1, and ``rr`` / ``rr_tau`` are rejected: this loop is
    the rollback/restart residual replacement.
    """
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.krylov.cg import pipecg
    from repro_torch.core.krylov.distributed import distributed_solve
    from repro_torch.core.krylov.options import SolverOptions
    from repro_torch.distributed import comm

    if options is not None:
        if not isinstance(options, SolverOptions):
            raise TypeError("options= must be a SolverOptions; got "
                            f"{type(options).__name__}")
        loose = [name for name, value, default in
                 (("tol", tol, 1e-10), ("maxiter", maxiter, 400),
                  ("M", M, None)) if value != default]
        if loose:
            raise TypeError(
                "pass the solve configuration either as options= or as "
                "loose kwargs, not both (options= given alongside "
                f"{sorted(loose)})")
        if options.engine not in (None, "sharded_fused"):
            raise ValueError(
                "resilient_distributed_solve runs the sharded fused "
                "engine (the only path that can checkpoint and resume "
                f"carried state); got engine={options.engine!r}")
        if options.depth != 1:
            raise ValueError(
                "the resilient segment loop checkpoints the depth-1 "
                f"carried tuple; depth={options.depth} is not restartable")
        if options.rr or options.rr_tau:
            raise ValueError(
                "rr= / rr_tau= are local-solver options; the resilient "
                "loop already re-glues via checkpoint rollback + x0= "
                "restarts")
        if options.noise is not None:
            if injector is not None:
                raise TypeError(
                    "options.noise and injector= fill the same hook "
                    "slot — pass exactly one")
            injector = options.noise
        tol, maxiter, M = options.tol, options.maxiter, options.M
        base_opts = options
    else:
        base_opts = SolverOptions(maxiter=maxiter, tol=tol, M=M)

    if solver is None:
        solver = pipecg
    me, n_shards0 = comm.rank_and_size(group)
    if n_shards0 != dist.get_world_size():
        raise ValueError(
            "resilient_distributed_solve makes survivor groups with "
            "new_group, which every process joins: group must span the "
            f"world ({n_shards0} of {dist.get_world_size()} processes)")
    b_np = b.detach().cpu().double().numpy()
    norm_b = float(np.linalg.norm(b_np))
    n_dofs = int(b_np.shape[-1])
    # ||A||_inf-style scale for the checksum trip threshold (host bands)
    a_inf = float(A.bands.detach().cpu().double().abs().sum(dim=0).max())
    alive = list(range(n_shards0))
    made_dir = None
    if ckpt_dir is None:
        path = [tempfile.mkdtemp(prefix="resilient_ckpt_") if me == 0
                else None]
        dist.broadcast_object_list(path, src=comm.global_rank(group, 0),
                                   group=group)
        ckpt_dir = made_dir = path[0]
    ckpt = CheckpointManager(ckpt_dir, keep=2, async_write=True)
    groups = {tuple(alive): group}

    def survivors():
        key = tuple(alive)
        if key not in groups:   # collective over the world: every rank
            groups[key] = dist.new_group(
                ranks=[comm.global_rank(group, r) for r in alive])
        return groups[key]

    last_good: Optional[dict] = None     # carried state of the last good
    last_good_iters = 0                  # segment, its productive iters
    last_good_res = norm_b               # and its residual norm
    ckpt_steps = 0
    carried = None          # exact-continuation state for the next segment
    x_restart = None        # rr-restart iterate for the next segment
    res_prev = norm_b       # last accepted residual norm (jump detector)
    productive = executed = seg = 0
    recoveries: List[RecoveryEvent] = []
    detections: List[abft.DetectionReport] = []
    segment_walls: List[float] = []
    result = None
    accepted = converged = False
    t_begin = time.perf_counter()
    seg_cap = (maxiter + checkpoint_period - 1) // checkpoint_period \
        + max_recoveries * 2 + 4

    def rollback():
        """The last good checkpoint's iterate (survivors) and counts.

        Decided on ``ckpt_steps``, which every rank shares: a rank outside
        ``alive`` holds no carried state, but still joins the barrier.
        """
        x = None
        if ckpt_steps > 0:
            ckpt.wait()
            dist.barrier(group=group)
            if me in alive:
                state, _ = ckpt.restore(last_good)
                x = state["x"] if b.dim() == 2 else state["x"][0]
            return x, last_good_iters, last_good_res
        return x, 0, norm_b

    def recoveries_guard():
        if len(recoveries) > max_recoveries:
            raise RuntimeError(
                f"gave up after {len(recoveries)} recoveries "
                f"(max_recoveries={max_recoveries}); events: {recoveries}")

    while productive < maxiter and seg < seg_cap:
        if len(alive) < min_shards:
            raise RuntimeError(
                f"only {len(alive)} shards left alive (min {min_shards})")
        seg_len = min(checkpoint_period, maxiter - productive)
        sub = survivors()
        if injector is not None:
            injector.set_mesh(alive)
        seg_start = executed
        t0 = time.perf_counter()
        seg_opts = dataclasses.replace(
            base_opts, maxiter=seg_len, tol=tol, M=M,
            engine="sharded_fused", noise=injector, depth=1,
            rr=0, rr_tau=0.0)
        res = carried_out = None
        if me in alive:
            res, carried_out = distributed_solve(
                solver, A, b, sub, options=seg_opts, x0=x_restart,
                carried=carried, with_state=True)
        beat = _heartbeat(injector, me, seg_start)
        if me == alive[0]:
            beat["norms"] = (float(res.res_norm),
                             res.res_history.detach().cpu().numpy(),
                             None if res.detect_history is None else
                             res.detect_history.detach().cpu().numpy())
        beats = [None] * n_shards0
        dist.all_gather_object(beats, beat, group=group)
        segment_walls.append(time.perf_counter() - t0)
        res_norm, hist, det = beats[alive[0]]["norms"]
        executed += seg_len
        seg += 1
        x_restart = None
        events = _merge_events(beats)

        # ---- detector 1: kill (poisoned reduction -> non-finite norm) ----
        if not np.isfinite(res_norm):
            dead = (sorted({s for s in alive if beats[s]["dead"]})
                    if injector is not None else [])
            if injector is None or not dead:
                raise RuntimeError(
                    "solve diverged to a non-finite residual with no dead "
                    "shard to blame — numerical breakdown, not a fault")
            onset = min((beats[s]["count"] if beats[s]["count"] is not None
                         else executed) - 1 for s in dead)
            for s in dead:
                alive.remove(s)
            carried = None
            x_restart, productive, res_prev = rollback()
            for s in dead:
                recoveries.append(RecoveryEvent(
                    kind="kill", shard=s, segment=seg - 1,
                    detect_iters=max(executed - onset, 1),
                    iters_lost=seg_len, n_shards_after=len(alive),
                    mode="rollback_restart", detector="psum_nan"))
            recoveries_guard()
            continue

        # ---- detector 2: corrupt, fast paths first: (a) the checksum
        # column the segment carried through its reductions, (b) a jump
        # in the norm history; the host true residual only confirms ----
        hist = np.asarray(hist, np.float64)
        hist = hist.reshape(-1, hist.shape[-1])      # (k_rhs, seg_len)
        chk_trip, chk_value, chk_threshold = -1, 0.0, 0.0
        if det is not None:
            det = np.asarray(det, np.float64)
            det = np.abs(det.reshape(-1, det.shape[-1])).max(axis=0)
            seg_scale = a_inf * max(res_prev, float(hist.max()),
                                    tol * norm_b)
            chk_threshold = abft.checksum_threshold(seg_scale, n_dofs,
                                                    b.dtype)
            chk_trip = abft.first_trip(det, chk_threshold)
            if chk_trip >= 0 and np.isfinite(det[chk_trip]):
                chk_value = float(det[chk_trip])
        prev = np.concatenate(
            [np.full((hist.shape[0], 1), res_prev), hist[:, :-1]], axis=1)
        jump_mask = hist > jump_factor * np.maximum(prev, tol * norm_b)
        jump_iter = (int(np.argmax(jump_mask.any(axis=0)))
                     if bool(jump_mask.any()) else -1)
        if chk_trip >= 0 or jump_iter >= 0:
            detector = "checksum" if chk_trip >= 0 else "history_jump"
            trip_iter = chk_trip if chk_trip >= 0 else jump_iter
            seg_start_iter = executed - seg_len
            confirmed = None
            if res is not None:   # slow-path confirm: ONE host ||b - A x||
                true_res = true_residual_norm(A, b_np, res.x)
                confirmed = bool(
                    not np.isfinite(true_res)
                    or true_res > drift_factor * max(res_norm, tol * norm_b)
                    or jump_iter >= 0)
            detections.append(abft.DetectionReport(
                solver="pipecg", detector=detector, tripped=True,
                trip_iter=seg_start_iter + trip_iter,
                value=chk_value if chk_trip >= 0 else float(hist.max()),
                threshold=chk_threshold, action="rollback",
                confirmed=confirmed))
            onset = seg_start_iter
            ev = [e for e in events if e.kind == "corrupt"]
            if ev:
                onset = ev[-1].at_iter
            shard = ev[-1].shard if ev else -1
            carried = None
            x_restart, productive, res_prev = rollback()
            recoveries.append(RecoveryEvent(
                kind="corrupt", shard=shard, segment=seg - 1,
                detect_iters=max(seg_start_iter + trip_iter + 1 - onset, 1),
                iters_lost=seg_len, n_shards_after=len(alive),
                mode="rollback_restart", detector=detector))
            recoveries_guard()
            continue

        # ---- detector 3: stall (persistent straggler in step times) ----
        evicted = None
        if injector is not None and len(alive) > max(min_shards, 1):
            steps = step_matrix([beats[s]["record"] for s in alive])
            rep = analyze_step_times(steps,
                                     restart_cost_steps=restart_cost_steps)
            if rep.persistent_outlier is not None:
                evicted = alive[rep.persistent_outlier]
                onset = executed - seg_len
                ev = [e for e in events
                      if e.kind == "stall" and e.shard == evicted]
                if ev:
                    onset = ev[-1].at_iter
                alive.remove(evicted)
                recoveries.append(RecoveryEvent(
                    kind="stall", shard=evicted, segment=seg - 1,
                    detect_iters=max(executed - onset, 1),
                    iters_lost=0, n_shards_after=len(alive),
                    mode="evict_continue", detector="step_times"))
                recoveries_guard()

        # ---- segment accepted: advance + checkpoint the carried state ----
        accepted = True
        result = res
        productive += seg_len
        carried = carried_out
        if carried_out is not None:     # a rank outside alive keeps its own
            last_good = carried_out
        last_good_iters, last_good_res = productive, res_norm
        res_prev = max(res_norm, tol * norm_b, 1e-300)
        ckpt_steps += 1
        if me == alive[0]:
            ckpt.save(ckpt_steps, carried_out,
                      extra={"productive": productive, "res_norm": res_norm,
                             "n_shards": len(alive)
                             + (1 if evicted is not None else 0)})
        if res_norm <= tol * norm_b:
            converged = True
            break

    ckpt.wait()
    if not accepted:
        raise RuntimeError("no segment completed cleanly")
    out = [None]
    if me == alive[0]:
        report = ResilientReport(
            converged=converged, res_norm=float(result.res_norm),
            true_res_norm=true_residual_norm(A, b_np, result.x),
            productive_iters=productive, executed_iters=executed,
            segments=seg, n_shards_final=len(alive), recoveries=recoveries,
            wall_s=time.perf_counter() - t_begin,
            segment_walls=segment_walls, detections=detections)
        out = [(result._replace(**{k: v.detach().cpu() for k, v in
                                   result._asdict().items()
                                   if isinstance(v, torch.Tensor)}),
                report)]
    dist.broadcast_object_list(out, src=comm.global_rank(group, alive[0]),
                               group=group)
    result, report = out[0]
    result = result._replace(**{k: v.to(b.device) for k, v in
                                result._asdict().items()
                                if isinstance(v, torch.Tensor)})
    dist.barrier(group=group)
    for key, g in groups.items():
        if g is not group and me in key:
            dist.destroy_process_group(g)
    if made_dir is not None and me == 0:
        shutil.rmtree(made_dir, ignore_errors=True)
    return result, report


def resilient_cases(rank: int, world: int, cases, device: str = "cuda"):
    """Rank body (``ranks.run``): one :func:`resilient_distributed_solve`
    per case, reported as numpy.

    A case holds ``A`` (a DiaMatrix) and ``b``, global, moved to
    ``device`` here, the ``kw`` of the solve, and optionally ``faults``
    (fault names), ``fault_kw`` (FaultSpec overrides), ``seed`` and
    ``policy`` (a precision preset name), from which this rank builds its
    own injector and options.  Returns, per case, the result's fields,
    the report as a dict, the wall seconds and this rank's kernel
    launches (counts set to 0 just before the solve, read just after).
    """
    from repro_torch.core.krylov.operators import DiaMatrix
    from repro_torch.core.krylov.options import PrecisionPolicy, SolverOptions
    from repro_torch.core.noise.faults import FaultInjector, make_faults
    from repro_torch.kernels import ops

    dev = torch.device(device)
    out = []
    for case in cases:
        A = DiaMatrix(offsets=case["A"].offsets,
                      bands=case["A"].bands.to(dev))
        b = case["b"].to(dev)
        kw = dict(case.get("kw", {}))
        inj = None
        if case.get("faults"):
            inj = FaultInjector(faults=make_faults(
                case["faults"], **case.get("fault_kw", {})),
                n_shards=world, seed=case.get("seed", 0))
        if case.get("policy"):
            kw["options"] = SolverOptions(
                maxiter=kw.pop("maxiter"), tol=kw.pop("tol"),
                precision=PrecisionPolicy.from_name(case["policy"]))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, rep = resilient_distributed_solve(A, b, injector=inj, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        out.append(dict(
            {k: (None if v is None else v.detach().cpu().numpy())
             for k, v in res._asdict().items()},
            report=dataclasses.asdict(rep), seconds=seconds,
            launches=ops.launch_counts()))
    return out
