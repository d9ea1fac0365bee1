"""Resynchronization-overhead model for elastic fault recovery.

The fault-tolerance layer (distributed/fault.py) runs the sharded PIPECG
solve in segments of ``period`` iterations, detects kill/stall/corrupt
faults at segment boundaries, and recovers by rollback + residual-
replacement restart (kill/corrupt) or eviction + exact continuation
(stall).  This module prices that machinery in the currency of the
paper's makespan model: one *iteration* costs

    t_iter(l) = (l*t0 + E[max_p sum_l W] + R) / l        (Eqs. 6/7 terms)

— the same block-resynchronization per-step time as
``perfmodel/depth.py``, with t0 the deterministic compute, W the paper's
stochastic waiting time, R the reduction latency, and l the pipeline
depth.  On top of it:

* a LOWER BOUND on the per-fault recovery overhead, in iterations — the
  work any boundary-synchronous scheme must redo or lose, ignoring
  everything implementation-specific (re-shard latency, compile time,
  restart-induced convergence delay), so a correctly-measured recovery
  should land ABOVE it and, for this repo's controller, within ~2x;
* the expected makespan of a K-iteration solve under a Poisson fault
  rate lambda (faults per iteration);
* the Young/Daly-style optimal checkpoint period derived from the same
  quadratic trade-off (checkpoint cost vs expected rework).

The Monte-Carlo term is ``depth.block_expected_max``; at l = 1 it is
``expected_max``, whose quadrature runs on ``device`` (the card unless
the caller asks for the CPU).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.perfmodel.depth import block_expected_max
from repro_torch.core.perfmodel.distributions import Distribution

FAULT_RECOVERY_KINDS = ("kill", "corrupt", "stall")


def detection_iters(period: int) -> float:
    """Expected boundary-synchronous detection latency, in iterations.

    A fault landing uniformly inside a ``period``-iteration segment is
    surfaced only at the segment boundary, so the expected latency is
    ``(period + 1) / 2`` (never less than one iteration: the poisoned
    reduction needs one psum to propagate).
    """
    if period < 1:
        raise ValueError("checkpoint period must be >= 1 iteration")
    return max((period + 1) / 2.0, 1.0)


def abft_detection_iters(magnitude: float, threshold: float,
                         period: int) -> float:
    """Expected detection latency WITH the in-flight ABFT checksum.

    A corruption whose checksum deflection exceeds the trip threshold is
    surfaced by the next carried reduction — the checksum row rides the
    same psum the corrupted payload does — so its latency is ONE
    iteration regardless of the segment period.  A sub-threshold
    corruption is invisible to the fast path and falls back to the
    boundary-synchronous ``(period + 1) / 2`` of :func:`detection_iters`
    (the slow-path true-residual check at the segment boundary).
    """
    if threshold < 0:
        raise ValueError("threshold must be >= 0")
    if magnitude > threshold:
        return 1.0
    return detection_iters(period)


def adaptive_rr_replacements(K: int, eps: float, tau: float) -> float:
    """Expected number of adaptive residual replacements in K iterations.

    The deviation recursion grows by ~3 eps ||r|| per iteration (the
    :func:`repro_torch.core.krylov.abft.deviation_update` increment with
    ``|alpha| ||w|| ~ ||r||``) and trips at ``tau ||r||``, so one
    replacement fires every ~``tau / (3 eps)`` iterations — the
    replacement CADENCE the adaptive scheme substitutes for a fixed
    ``rr=`` period.
    """
    if K < 0:
        raise ValueError("K must be >= 0")
    if eps <= 0 or tau <= 0:
        raise ValueError("eps and tau must be > 0")
    return K / (tau / (3.0 * eps))


def adaptive_rr_overhead_iters(K: int, eps: float, tau: float, *,
                               l: int = 1, s_sync: int = 1) -> float:
    """Expected iteration-equivalents spent on adaptive replacements.

    Each re-glue ``r = b - A x`` (plus operator images) costs one extra
    sweep and the ``l * s_sync`` pipeline-refill iterations the restart
    spends rebuilding the overlap window — the same refill term as
    :func:`recovery_overhead_bound`, but paid at the adaptive cadence of
    :func:`adaptive_rr_replacements` instead of per-fault.
    """
    if l < 1 or s_sync < 1:
        raise ValueError("pipeline depth l and sync count s must be >= 1")
    per_replace = 1.0 + float(l * s_sync)
    return adaptive_rr_replacements(K, eps, tau) * per_replace


def recovery_overhead_bound(kind: str, period: int, *, l: int = 1,
                            s_sync: int = 1) -> float:
    """Lower bound on one fault's recovery overhead, in ITERATIONS.

    * ``kill`` / ``corrupt`` — the segment that absorbed the fault is
      poisoned end to end (the NaN/garbage tick rides every subsequent
      reduction), so rollback must re-execute its full ``period``
      iterations, plus the ``l * s_sync`` pipeline-refill iterations the
      residual-replacement restart spends rebuilding the overlap window
      (one warm-up step per hidden synchronization, per depth level).
    * ``stall`` — eviction continues EXACTLY from the segment's carried
      state (nothing is rolled back), so the unavoidable cost is the
      detection latency itself: the expected ``(period+1)/2`` iterations
      executed at the straggler's degraded speed before the boundary
      check sees it.

    Re-shard latency, recompilation and restart-induced convergence
    delay are deliberately omitted — this is the floor the measured
    overhead is validated against (campaign acceptance: within 2x).
    """
    if kind not in FAULT_RECOVERY_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r}; known: {FAULT_RECOVERY_KINDS}")
    if l < 1 or s_sync < 1:
        raise ValueError("pipeline depth l and sync count s must be >= 1")
    if kind == "stall":
        return detection_iters(period)
    return float(period) + float(l * s_sync)


def resync_iter_time(dist: Optional[Distribution], P: int, *,
                     t0: float = 0.0, red_latency: float = 0.0,
                     l: int = 1, trials: int = 4000, seed: int = 0,
                     device="cuda") -> float:
    """Per-iteration time t_iter(l) from the Eq. 6/7 terms.

    ``dist=None`` means no stochastic waiting time (t_iter = t0 + R/l).
    Units are whatever ``dist``/``t0``/``red_latency`` are expressed in.
    """
    if l < 1:
        raise ValueError("pipeline depth l must be >= 1")
    if P < 1:
        raise ValueError("P must be >= 1")
    e_block = (0.0 if dist is None
               else block_expected_max(dist, P, l, trials=trials, seed=seed,
                                       device=device))
    return (l * t0 + e_block + red_latency) / l


def expected_fault_makespan(dist: Optional[Distribution], P: int, K: int,
                            lam: float, period: int, *, t0: float = 0.0,
                            red_latency: float = 0.0, l: int = 1,
                            s_sync: int = 1, reshard_cost: float = 0.0,
                            kind: str = "kill", trials: int = 4000,
                            seed: int = 0, device="cuda") -> float:
    """Expected makespan of a K-iteration solve under fault rate ``lam``.

    ``lam`` is the per-iteration fault probability (Poisson thinning of a
    wall-clock rate by t_iter).  Expected faults = lam * K; each costs at
    least ``recovery_overhead_bound(kind, period)`` iterations of rework/
    loss plus the (implementation-specific, caller-supplied)
    ``reshard_cost`` seconds:

        T = K * t_iter + lam * K * (bound_iters * t_iter + reshard_cost)

    With ``lam = 0`` this reduces exactly to the fault-free pipelined
    makespan ``K * t_iter(l)`` of the depth model.
    """
    if lam < 0:
        raise ValueError("fault rate lam must be >= 0")
    if K < 0:
        raise ValueError("K must be >= 0")
    t_iter = resync_iter_time(dist, P, t0=t0, red_latency=red_latency, l=l,
                              trials=trials, seed=seed, device=device)
    per_fault = (recovery_overhead_bound(kind, period, l=l, s_sync=s_sync)
                 * t_iter + reshard_cost)
    return K * t_iter + lam * K * per_fault


def optimal_checkpoint_period(checkpoint_cost_iters: float,
                              lam: float) -> float:
    """Young/Daly optimal checkpoint period, in iterations.

    Minimizes the per-iteration overhead of checkpointing every C
    iterations under per-iteration fault rate ``lam``: cost(C) =
    delta / C  +  lam * C / 2  (amortized checkpoint write + expected
    rework of half a segment), giving  C* = sqrt(2 * delta / lam) —
    Young's first-order formula with time measured in iterations (Daly's
    higher-order corrections change nothing at the rates swept here).
    ``lam = 0`` returns ``inf`` (never checkpoint if nothing ever fails).
    """
    if checkpoint_cost_iters < 0:
        raise ValueError("checkpoint cost must be >= 0")
    if lam < 0:
        raise ValueError("fault rate lam must be >= 0")
    if lam == 0.0:
        return math.inf
    return math.sqrt(2.0 * checkpoint_cost_iters / lam)
