"""Campaign ABFT stage: detection coverage of the in-flight detectors (the
JAX package's ``experiments/abft_exec.py``).

Sweeps corruption magnitude x solver x detector over REAL many-rank
sharded solves, all cells in one spawn of ``spec.abft_shards`` ranks
(``distributed/ranks.py``; the JAX package forces host devices in a
subprocess).  Per cell every rank runs:

* a CLEAN twin — the same sharded solve with no injector.  Its carried
  detector history (``SolveResult.detect_history``: the checksum row
  ``1^T w - c^T u`` for the depth-1 pipecg/pipebicgstab bodies, the
  state deviation ``1^T(b - A x - r)`` for the depth-l blocks) must
  never cross the trip threshold: the measured FALSE-POSITIVE rate of
  the acceptance gate is the fraction of clean cells that trip.
* a CORRUPT run — one silent ``corrupt`` fault of the cell's magnitude
  injected into the carried reduction mid-solve.  The measured
  detection latency is the gap between the fault onset and the first
  detector-history trip; a supra-threshold corruption must trip within
  the modeled window (1 iteration for the depth-1 bodies, l for the
  block-granular depth path — ``resync.abft_detection_iters``), while a
  sub-threshold one is expected NOT to trip (it is below the rounding
  floor the threshold guards).
* for pipecg, the elastic controller (``resilient_distributed_solve``)
  under the same fault — its RecoveryEvent must name the ``checksum``
  fast path, and its in-flight ``detect_iters`` is compared against the
  boundary-synchronous ``(period + 1) / 2`` of a segment-boundary
  true-residual check (``resync.detection_iters``): the latency the
  carried checksum buys back.

CLI (on the card; ``--device cpu`` runs the plain versions on the host)::

    PYTHONPATH=src python -m repro_torch.experiments.abft_exec \\
        [--preset smoke] [--seed 0] [--out chiprun_out/abft_exec.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

DEFAULT_OUT = "chiprun_out/abft_exec.json"


def detection_window(solver: str, depth: int) -> int:
    """Modeled in-flight detection window, in iterations (depth-1 bodies
    trip on the next carried reduction; the depth-l path reduces once per
    l-iteration block, plus one-iteration slack for the carried-unreduced
    handoff)."""
    return (depth if solver == "pipecg_l" else 1) + 1


def abft_rank_cells(rank: int, world: int, cfg: Dict,
                    device: str = "cuda") -> Dict:
    """Rank body: every cell of ``cfg`` on the whole group; returns the
    cells, the clean twins and this rank's kernel launches."""
    from repro_torch.core.krylov import abft
    from repro_torch.core.krylov.bicgstab import pipebicgstab
    from repro_torch.core.krylov.cg import pipecg
    from repro_torch.core.krylov.distributed import distributed_solve
    from repro_torch.core.krylov.options import SolverOptions
    from repro_torch.core.krylov.pipeline import pipecg_l
    from repro_torch.core.noise.faults import FaultInjector, FaultSpec
    from repro_torch.core.perfmodel.resync import (abft_detection_iters,
                                                   detection_iters)
    from repro_torch.distributed.fault import resilient_distributed_solve
    from repro_torch.experiments.fault_exec import _shifted_laplacian
    from repro_torch.kernels import ops

    n = int(cfg["n"])
    P = world
    maxiter = int(cfg["maxiter"])
    tol = float(cfg["tol"])
    depth = int(cfg["depth"])
    period = int(cfg["checkpoint_period"])
    seed = int(cfg["seed"])
    A = _shifted_laplacian(n, device=device)
    b = torch.ones((n,), dtype=A.dtype, device=device)
    a_inf = float(A.bands.abs().sum(dim=0).max())
    norm_b = float(torch.linalg.vector_norm(b))
    solver_fns = {"pipecg": pipecg, "pipebicgstab": pipebicgstab,
                  "pipecg_l": pipecg_l}
    ops.reset_launch_counts()

    def solve(solver, injector=None):
        opts = SolverOptions(
            engine="sharded_fused", tol=tol, maxiter=maxiter,
            noise=injector, depth=depth if solver == "pipecg_l" else 1)
        res = distributed_solve(solver_fns[solver], A, b, None,
                                options=opts)
        det = np.abs(res.detect_history.double().cpu().numpy())
        hist = res.res_history.double().cpu().numpy()
        return res, det, hist

    clean: Dict[str, Dict] = {}
    cells: List[Dict] = []
    for ci, cell in enumerate(cfg["cells"]):
        solver = cell["solver"]
        mag = float(cell["magnitude"])
        detector = ("state_deviation" if solver == "pipecg_l"
                    else "checksum")
        if solver not in clean:
            res0, det0, hist0 = solve(solver)
            # trip threshold: rounding floor of an n-term checksum at the
            # solve's own scale (||A||_inf x the largest residual seen),
            # with the abft.DEFAULT_TAU headroom — shared by the clean
            # false-positive gate and the corrupt-run trip scan
            scale = a_inf * max(float(hist0.max()), norm_b)
            thr = abft.checksum_threshold(scale, n, torch.float64)
            clean[solver] = {
                "threshold": thr,
                "clean_trip": abft.first_trip(det0, thr),
                "clean_max": float(det0.max()),
                "clean_iters": int(res0.iters),
                "converged": bool(float(res0.res_norm) <= tol * norm_b),
            }
        base = clean[solver]
        thr = base["threshold"]

        rng = np.random.default_rng((seed, ci))
        # the fault must land mid-solve: a corruption injected after the
        # trajectory froze (converged) never enters the carried
        # reduction.  The injector counts REDUCTIONS, and the depth-l
        # body reduces once per l-iteration block, so its onset is drawn
        # (and converted back) in block units.
        ticks_per = depth if solver == "pipecg_l" else 1
        hi = max(3, int(0.6 * base["clean_iters"] / ticks_per))
        onset = int(rng.integers(2, hi))
        onset_iters = onset * ticks_per
        shard = int(rng.integers(0, P))

        def injector():
            return FaultInjector(
                faults=[FaultSpec(kind="corrupt", shard=shard,
                                  at_iter=onset, magnitude=mag)],
                n_shards=P, seed=seed + ci)
        res, det, hist = solve(solver, injector=injector())
        trip = abft.first_trip(det, thr)
        window = detection_window(solver, depth)
        expect_trip = mag > thr
        detect_lag = (trip + 1 - onset_iters) if trip >= 0 else -1
        modeled = abft_detection_iters(mag, thr, period)
        row = {
            "solver": solver, "detector": detector, "magnitude": mag,
            "onset_iter": onset_iters, "fault_shard": shard,
            "threshold": thr, "trip_iter": trip,
            "detect_lag_iters": detect_lag,
            "window_iters": window,
            "expect_trip": bool(expect_trip),
            "tripped": bool(trip >= 0),
            "detected_in_window": bool(
                trip >= 0 and 0 <= detect_lag <= window),
            "modeled_detect_iters": float(modeled),
            "boundary_detect_iters": float(detection_iters(period)),
            "clean_trip_iter": int(base["clean_trip"]),
            "clean_max_value": base["clean_max"],
            "false_positive": bool(base["clean_trip"] >= 0),
            "converged": bool(float(res.res_norm) <= tol * norm_b),
            "skipped": False,
        }
        # pipecg only: close the loop through the elastic controller —
        # the fast path must drive the recovery and beat the latency of
        # the every-segment true-residual check
        if solver == "pipecg" and expect_trip:
            _, rep = resilient_distributed_solve(
                A, b, injector=injector(), tol=tol, maxiter=maxiter,
                checkpoint_period=period)
            ev = [e for e in rep.recoveries if e.kind == "corrupt"]
            row.update({
                "recovered": bool(ev),
                "recovery_detector": ev[0].detector if ev else "",
                "recovery_detect_iters": (float(ev[0].detect_iters)
                                          if ev else -1.0),
                "recovery_converged": bool(rep.converged),
                "recovery_overhead_iters": float(
                    rep.executed_iters - rep.productive_iters),
            })
        cells.append(row)

    return {"cells": cells, "clean": clean,
            "n": n, "shards": P, "maxiter": maxiter, "tol": tol,
            "depth": depth, "checkpoint_period": period,
            "launches": ops.launch_counts()}


def _cells(spec) -> List[Dict]:
    return [{"solver": s, "magnitude": m}
            for s in spec.abft_solvers
            for m in spec.abft_magnitudes]


def abft_jobs(spec) -> List:
    """The stage's rank job (none without solvers or when
    ``spec.abft_shards`` does not divide ``spec.abft_n``)."""
    from repro_torch.experiments.runner import RankJob

    if not spec.abft_solvers or spec.abft_n % spec.abft_shards:
        return []
    return [RankJob("abft", spec.abft_shards, abft_rank_cells, {
        "n": spec.abft_n, "maxiter": spec.abft_maxiter,
        "tol": spec.abft_tol, "depth": spec.abft_depth,
        "checkpoint_period": spec.fault_checkpoint_period,
        "seed": spec.seed, "cells": _cells(spec)})]


def abft_record(spec, outs: List[List[Dict]]) -> Dict:
    """The stage's record from its job's per-rank outputs."""
    if not spec.abft_solvers:
        return {"cells": [], "clean": {}}
    if not outs:
        return {"cells": [{**c, "skipped": True,
                           "reason": f"{spec.abft_shards} ranks, "
                                     f"n={spec.abft_n}"}
                          for c in _cells(spec)], "clean": {}}
    return {k: v for k, v in outs[0][0].items()
            if k not in ("launches", "seconds")}


def run_abft_exec(spec, device="cuda") -> Dict:
    """Run the ABFT stage of ``spec`` alone on ``spec.abft_shards`` spawned
    ranks (on ``device``, the card unless the caller asks for the CPU) and
    return its record (the CLI; ``run_campaign`` runs :func:`abft_jobs`
    in its own spawn)."""
    from repro_torch.experiments.runner import run_rank_jobs

    return abft_record(spec, run_rank_jobs(abft_jobs(spec), device))


def bench_record(abft: Dict) -> Dict:
    """Flatten an ABFT stage record into gate rows (the JAX package's
    ``BENCH_abft.json`` row schema)."""
    rows: Dict[str, Dict] = {}
    for c in abft.get("cells", []):
        if c.get("skipped"):
            continue
        key = f"{c['solver']}_mag{c['magnitude']:g}"
        rows[key] = {
            "detector": c["detector"],
            "tripped": bool(c["tripped"]),
            "expect_trip": bool(c["expect_trip"]),
            "detected_in_window": bool(c["detected_in_window"]),
            "modeled_detect_iters": float(c["modeled_detect_iters"]),
            "boundary_detect_iters": float(c["boundary_detect_iters"]),
            "false_positive": bool(c["false_positive"]),
            "detection_ok": bool(
                (c["detected_in_window"] if c["expect_trip"]
                 else not c["tripped"])
                and not c["false_positive"]),
        }
        # the lag is gated "lower is better"; no-trip cells carry -1,
        # which a relative tolerance band would flag spuriously — omit
        # the metric there
        if c["tripped"]:
            rows[key]["detect_lag_iters"] = float(c["detect_lag_iters"])
        if "recovered" in c:
            rows[key].update({
                "recovered": bool(c["recovered"]),
                "recovery_detector": c["recovery_detector"],
                "recovery_detect_iters": float(
                    c["recovery_detect_iters"]),
                "recovery_converged": bool(c["recovery_converged"]),
            })
    return {"abft": rows}


def main(argv=None) -> int:
    """CLI entry point (``python -m repro_torch.experiments.abft_exec``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.abft_exec",
        description="ABFT detection-coverage benchmark: corruption "
                    "magnitude x solver x detector over sharded solves.")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from repro_torch.experiments.report import write_json
    from repro_torch.experiments.spec import get_preset
    spec = get_preset(args.preset)
    if args.seed is not None:
        spec = dataclasses.replace(spec, seed=args.seed)

    abft = run_abft_exec(spec, device=args.device)
    record = bench_record(abft)
    record["detail"] = abft
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_json(out, record)

    ok = all(r["detection_ok"] for r in record["abft"].values())
    for key, r in sorted(record["abft"].items()):
        lag = r.get("detect_lag_iters", -1.0)
        print(f"{key}: tripped={int(r['tripped'])} "
              f"lag={lag:.0f} (window ok={int(r['detected_in_window'])}, "
              f"boundary={r['boundary_detect_iters']:.1f}) "
              f"fp={int(r['false_positive'])}")
    print(f"abft stage: {'OK' if ok else 'FAILED'} "
          f"({len(record['abft'])} cells) -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
