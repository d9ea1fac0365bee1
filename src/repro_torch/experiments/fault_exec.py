"""Campaign fault stage: real shard-loss recovery, measured vs modeled (the
JAX package's ``experiments/fault_exec.py``).

Sweeps fault kind x rate x shard count over REAL many-rank solves.  The
JAX package forces host devices in a subprocess; the port spawns ranks
(``distributed/ranks.py``), one spawn per shard count P with every cell
of that P inside it: ``resilient_distributed_solve`` makes its survivor
groups with ``new_group``, which every process of the world joins, so
its group spans the whole spawn.

Per cell every rank runs the elastic controller
(``distributed/fault.py::resilient_distributed_solve``) twice on a
shifted tridiagonal Laplacian (kappa ~ 5, so the solve converges to
1e-10 in a few dozen iterations):

* a CLEAN baseline (no injector), once per P: its executed-iteration
  count and wall time are the zero-fault reference;
* a FAULTY run with one scheduled fault whose onset iteration is drawn
  geometrically from the cell's rate (one fault per run: the model's
  bound is per fault), each rank building the same injector.

The measured recovery overhead is iteration-denominated — rolled-back +
re-executed iterations for kill/corrupt (``executed_faulty -
executed_clean``), boundary detection latency for stall (the iterations
run at degraded speed before eviction) — and validated against
``core/perfmodel/resync.py::recovery_overhead_bound``, the
implementation-agnostic floor (campaign acceptance: within 2x).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _shifted_laplacian(n: int, device="cuda"):
    """Tridiagonal Laplacian + identity: SPD with kappa ~ 5.

    The plain Laplacian's kappa ~ n^2 would need O(n) iterations; the
    unit shift keeps every fault cell's solve at a few dozen iterations.
    """
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.core.krylov.operators import DiaMatrix

    A0 = tridiagonal_laplacian(n, device=device)
    bands = A0.bands.clone()
    bands[A0.offsets.index(0)] += 1.0
    return DiaMatrix(offsets=A0.offsets, bands=bands)


def fault_rank_cells(rank: int, world: int, cfg: Dict,
                     device: str = "cuda") -> Dict:
    """Rank body: every ``(ci, cell)`` of ``cfg["cells"]`` (all of this
    world's P) on the whole group; returns the cells, the clean baseline
    and this rank's kernel launches."""
    from repro_torch.core.noise.faults import FaultInjector, FaultSpec
    from repro_torch.core.perfmodel.resync import recovery_overhead_bound
    from repro_torch.distributed.fault import resilient_distributed_solve
    from repro_torch.kernels import ops

    n = int(cfg["n"])
    maxiter = int(cfg["maxiter"])
    period = int(cfg["checkpoint_period"])
    tol = float(cfg["tol"])
    stall_s = float(cfg["stall_s"])
    seed = int(cfg["seed"])
    A = _shifted_laplacian(n, device=device)
    b = torch.ones((n,), dtype=A.dtype, device=device)
    P = world
    ops.reset_launch_counts()

    _, rep0 = resilient_distributed_solve(
        A, b, tol=tol, maxiter=maxiter, checkpoint_period=period)
    base = {"executed_iters": rep0.executed_iters,
            "productive_iters": rep0.productive_iters,
            "wall_s": rep0.wall_s,
            "true_res": rep0.true_res_norm,
            "converged": rep0.converged}
    cells: List[Dict] = []
    for ci, cell in cfg["cells"]:
        kind = cell["kind"]
        rate = float(cell["rate"])
        # one fault per run; the rate parameterizes the onset draw
        # (geometric = discretized Poisson), capped to land mid-solve so
        # the fault cannot miss an already-converged trajectory
        rng = np.random.default_rng((seed, ci))
        onset = int(rng.geometric(min(max(rate, 1e-6), 0.5)))
        onset = max(2, min(onset,
                           max(2, int(0.6 * base["productive_iters"]))))
        shard = int(rng.integers(0, P))
        inj = FaultInjector(
            faults=[FaultSpec(kind=kind, shard=shard, at_iter=onset,
                              stall_s=stall_s)],
            n_shards=P, seed=seed + ci)
        _, rep = resilient_distributed_solve(
            A, b, injector=inj, tol=tol, maxiter=maxiter,
            checkpoint_period=period)
        events = [e for e in rep.recoveries if e.kind == kind]
        recovered = bool(events)
        if kind == "stall":
            # no rollback: the cost is the detection latency itself
            overhead_iters = float(events[0].detect_iters) if events else 0.0
        else:
            overhead_iters = float(rep.executed_iters
                                   - base["executed_iters"])
        bound = recovery_overhead_bound(kind, period)
        cells.append((ci, {
            "kind": kind, "rate": rate, "n_shards": P,
            "fault_shard": shard, "onset_iter": onset,
            "recovered": recovered, "converged": rep.converged,
            "res_norm": rep.res_norm, "true_res": rep.true_res_norm,
            "clean_true_res": base["true_res"],
            "executed_iters": rep.executed_iters,
            "clean_executed_iters": base["executed_iters"],
            "productive_iters": rep.productive_iters,
            "n_shards_final": rep.n_shards_final,
            "detect_iters": (float(events[0].detect_iters)
                             if events else -1.0),
            "overhead_iters": overhead_iters,
            "bound_iters": float(bound),
            "overhead_ratio": (overhead_iters / bound if bound > 0
                               else 0.0),
            "wall_s": rep.wall_s, "clean_wall_s": base["wall_s"],
            "wall_ratio": rep.wall_s / max(base["wall_s"], 1e-12),
            "skipped": False,
        }))
    return {"cells": cells, "clean": base, "launches": ops.launch_counts()}


def _grid(spec) -> List[Dict]:
    return [{"kind": k, "rate": r, "n_shards": p}
            for k in spec.fault_kinds
            for r in spec.fault_rates
            for p in spec.fault_shard_counts]


def fault_jobs(spec) -> List:
    """The stage's rank jobs: one per shard count P that divides
    ``spec.fault_n``, with that P's cells."""
    from repro_torch.experiments.runner import RankJob

    cfg = {
        "n": spec.fault_n, "maxiter": spec.fault_maxiter,
        "checkpoint_period": spec.fault_checkpoint_period,
        "tol": spec.fault_tol, "stall_s": spec.fault_stall_s,
        "seed": spec.seed,
    }
    grid = _grid(spec)
    return [RankJob("fault", P, fault_rank_cells, dict(
                cfg, cells=[(ci, c) for ci, c in enumerate(grid)
                            if c["n_shards"] == P]))
            for P in dict.fromkeys(spec.fault_shard_counts)
            if not spec.fault_n % P]


def fault_record(spec, outs: List[List[Dict]]) -> Dict:
    """The stage's record from its jobs' per-rank outputs (cells whose P
    does not divide ``spec.fault_n`` recorded as skipped)."""
    grid = _grid(spec)
    by_ci: Dict[int, Dict] = {
        ci: {**c, "skipped": True,
             "reason": f"{c['n_shards']} ranks, n={spec.fault_n}"}
        for ci, c in enumerate(grid) if spec.fault_n % c["n_shards"]}
    clean: Dict[str, Dict] = {}
    for per_rank in outs:
        by_ci.update(dict(per_rank[0]["cells"]))
        P = per_rank[0]["cells"][0][1]["n_shards"]
        clean[str(P)] = per_rank[0]["clean"]
    return {"cells": [by_ci[ci] for ci in range(len(grid))],
            "clean": clean, "n": spec.fault_n,
            "maxiter": spec.fault_maxiter,
            "checkpoint_period": spec.fault_checkpoint_period,
            "tol": spec.fault_tol, "stall_s": spec.fault_stall_s}
