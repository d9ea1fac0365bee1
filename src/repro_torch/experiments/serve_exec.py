"""Campaign serve stage: the continuous batcher under open-loop load.

Three measurements against ONE operator family (the tridiagonal
Laplacian, ``spec.serve_n`` rows, on ``device``), all on the warm path
(first-call costs are paid in an explicit warmup round, exactly how a
serving process amortizes them):

1. **burst**: ``spec.serve_requests`` burst requests through the k-slot
   batcher vs the SAME requests through a k=1 sequential server:
   throughput, batch occupancy, p50/p99/p999 latency.
2. **accuracy**: a sample of the batched run's retired solutions against
   the same requests served SOLO (one active column, identical batch
   shape): mid-flight admission/retirement must not perturb a column, so
   the iteration counts are equal and the solutions agree bit for bit
   (``match_1e10`` keeps the reference's 1e-10 name; ``bitwise`` says
   whether they are identical).
3. **paced**: arrivals at utilization ``spec.serve_rho`` with the
   measured per-iteration batch time: a real wall-clock serve run
   (recorded), a deterministic discrete-event replay of the batcher
   (``core/perfmodel/queueing.simulate_batch_queue``: the measured side
   of the model gate), and the analytic M/G/k sojourn quantiles
   (``predicted_sojourn_quantiles``: Eq. 6/7 iteration time x a
   queueing-delay term).  The gate: predicted p50/p99 within the
   campaign's speedup-cell tolerance (0.10) of the deterministic replay;
   p999 is recorded (tail atoms of a finite run are coarser).

Each server run also records ``run_counts`` (blocks, admissions, batchers
built, kernel launches; ``serve/server.py``).  The JAX package's record
also carries ``autotune_stats``; the port has no block autotuner yet (its
block sizes are fixed), so that key is absent.

CLI (on the card; ``--device cpu`` runs the plain versions on the host)::

    PYTHONPATH=src python -m repro_torch.experiments.serve_exec \\
        [--preset smoke] [--requests 64] [--k-slots 8] [--n 256] \\
        [--seed 0] [--out chiprun_out/serve.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.perfmodel.queueing import (
    predicted_sojourn_quantiles,
    quantile_key,
    simulate_batch_queue,
)
from repro_torch.experiments.spec import CampaignSpec, get_preset

QUANTILES = (0.5, 0.99, 0.999)
DEFAULT_OUT = "chiprun_out/serve_exec.json"


def _fresh(reqs: Sequence) -> List:
    """Independent copies of a request list (servers stamp rids)."""
    return [dataclasses.replace(r) for r in reqs]


def _serve(reqs: Sequence, *, k_slots: int, engine: str,
           step_block: int, chaos=None):
    """Run one warmed server over ``reqs``; returns the drained server."""
    # deferred import: repro_torch.serve's load generator imports the
    # experiments package (noise machinery), so a module-scope import
    # here would be circular
    from repro_torch.serve import SolverServer

    srv = SolverServer(k_slots=k_slots, engine=engine,
                       step_block=step_block, chaos=chaos)
    srv.warmup(reqs[0])
    srv.submit_all(list(reqs))
    srv.stats = srv.run()
    return srv


def _burst_stage(spec: CampaignSpec, reqs: Sequence):
    """Batched vs sequential throughput on a burst of ready requests;
    returns the record and the two drained servers."""
    batched = _serve(_fresh(reqs), k_slots=spec.serve_k_slots,
                     engine=spec.serve_engine,
                     step_block=spec.serve_step_block)
    seq = _serve(_fresh(reqs), k_slots=1, engine=spec.serve_engine,
                 step_block=spec.serve_step_block)
    tp_b = batched.stats.throughput_rps
    tp_s = seq.stats.throughput_rps
    return {
        "n_requests": len(reqs), "k_slots": spec.serve_k_slots,
        "n": spec.serve_n, "engine": spec.serve_engine,
        "step_block": spec.serve_step_block,
        "batched": batched.stats.as_dict(),
        "sequential": seq.stats.as_dict(),
        "throughput_speedup": (tp_b / tp_s if tp_s > 0 else 0.0),
        "run_counts": {"batched": batched.run_counts,
                       "sequential": seq.run_counts},
    }, batched, seq


def _accuracy_stage(spec: CampaignSpec, server, reqs: Sequence,
                    n_check: int = 4) -> List[Dict]:
    """Batched retired solutions vs the same requests served solo."""
    by_rid = {r.rid: r for r in server.records}
    cells = []
    for req in list(reqs)[:n_check]:
        solo = _serve([dataclasses.replace(req)],
                      k_slots=spec.serve_k_slots,
                      engine=spec.serve_engine,
                      step_block=spec.serve_step_block)
        batched_rec = by_rid[req.rid]
        solo_rec = solo.records[0]
        diff = float(np.max(np.abs(np.asarray(batched_rec.x)
                                   - np.asarray(solo_rec.x))))
        cells.append({
            "rid": req.rid,
            "iters_batched": batched_rec.iters,
            "iters_solo": solo_rec.iters,
            "max_abs_diff": diff,
            "match_1e10": bool(diff <= 1e-10
                               and batched_rec.iters == solo_rec.iters),
            "bitwise": bool(np.array_equal(batched_rec.x, solo_rec.x)),
            "run_counts": solo.run_counts,
        })
    return cells


def _paced_stage(spec: CampaignSpec, A, server):
    """Utilization-paced arrivals: wall clock vs replay vs M/G/k model;
    returns the record, the drained wall-clock server and its requests."""
    from repro_torch.serve import arrival_times, synthetic_requests

    B = spec.serve_step_block
    k = spec.serve_k_slots
    n_blocks = len(server.per_block_active)
    t_blk = server.stats.wall_s / max(n_blocks, 1)
    t_iter = t_blk / B
    # block-quantized service demands, as the batcher actually spends them
    iters = np.array(sorted(r.iters for r in server.records))
    service_blocks = -(-iters // B)
    service_s = service_blocks * t_blk
    lam = spec.serve_rho * k / float(service_s.mean())

    n = spec.serve_requests
    arrivals = arrival_times(spec.serve_arrival, n, lam,
                             seed=spec.seed + 1, device=A.device)
    # real wall-clock paced run (warm path; recorded, not gated)
    paced_reqs = synthetic_requests(
        A, n, tol=spec.serve_tol, maxiter=spec.serve_maxiter,
        arrival=arrivals, modes=spec.serve_modes, seed=spec.seed + 2)
    wall = _serve(paced_reqs, k_slots=k, engine=spec.serve_engine,
                  step_block=B)
    # steady-state deterministic replay: the analytic model is a
    # steady-state law, so the measured side of the gate is the batcher's
    # discrete-event dynamics over a LONG horizon of requests whose
    # demands are bootstrapped from the measured per-request iteration
    # counts of the wall run (the short wall run itself is transient:
    # recorded above, not gated)
    by_rid = {r.rid: r.iters for r in wall.records}
    measured_demands = np.array([by_rid[r.rid] for r in paced_reqs])
    n_replay = max(int(spec.serve_replay_requests), n)
    rng = np.random.default_rng(spec.seed + 4)
    demands = rng.choice(measured_demands, size=n_replay)
    replay_arrivals = arrival_times(spec.serve_arrival, n_replay, lam,
                                    seed=spec.seed + 5, device=A.device)
    sim = simulate_batch_queue(replay_arrivals, demands, t_iter, k,
                               step_block=B)
    sim_q = {quantile_key(q): float(np.quantile(sim["latency"], q))
             for q in QUANTILES}
    # the analytic model sees the same block-quantized empirical service
    # law the replay consumed; only the WAIT term is modeled
    replay_service_s = (-(-demands // B)) * t_blk
    predicted = predicted_sojourn_quantiles(lam, replay_service_s, k,
                                            qs=QUANTILES)
    rel_err = {key: abs(sim_q[key] - predicted[key]) / sim_q[key]
               for key in sim_q}
    return {
        "lam": lam, "rho": spec.serve_rho, "arrival": spec.serve_arrival,
        "t_iter_s": t_iter, "service_mean_s": float(service_s.mean()),
        "n_replay": n_replay,
        "wall": wall.stats.as_dict(),
        "sim": sim_q, "sim_occupancy": sim["occupancy"],
        "predicted": predicted, "rel_err": rel_err,
        "run_counts": wall.run_counts,
    }, wall, paced_reqs


def run_serve_exec(spec: CampaignSpec, device="cuda") -> Dict:
    """Run the serve stage of ``spec`` on ``device``; returns the serve
    record.  Its ``"_servers"`` holds the drained servers and the request
    lists (for checks that read records and x; :func:`bench_record` and
    :func:`jsonable` skip keys that start with ``_``)."""
    from repro_torch.core.krylov.operators import tridiagonal_laplacian
    from repro_torch.serve import synthetic_requests

    A = tridiagonal_laplacian(spec.serve_n, device=device)
    reqs = synthetic_requests(A, spec.serve_requests, tol=spec.serve_tol,
                              maxiter=spec.serve_maxiter,
                              modes=spec.serve_modes, seed=spec.seed)
    burst, server, seq = _burst_stage(spec, reqs)
    accuracy = _accuracy_stage(spec, server, reqs)
    paced, wall, paced_reqs = _paced_stage(spec, A, server)
    return {
        "burst": burst,
        "accuracy": accuracy,
        "paced": paced,
        "trace_counts": dict(
            next(iter(server.batchers.values())).trace_counts),
        "_servers": {"batched": server, "sequential": seq, "paced": wall,
                     "burst_requests": reqs,
                     "paced_requests": paced_reqs},
    }


def bench_record(serve: Dict) -> Dict:
    """Flatten a serve record into gate rows (the JAX package's
    ``BENCH_serve.json`` row schema)."""
    burst, paced = serve["burst"], serve["paced"]
    b = burst["batched"]
    acc_ok = all(c["match_1e10"] for c in serve["accuracy"])
    rows = {
        f"burst_k{burst['k_slots']}_n{burst['n']}": {
            "throughput_speedup": burst["throughput_speedup"],
            "throughput_rps": b["throughput_rps"],
            "occupancy_mean": b["occupancy_mean"],
            "p50_s": b["latency"]["p50"],
            "p99_s": b["latency"]["p99"],
            "p999_s": b["latency"]["p999"],
            "drained": bool(b["drained"]),
            "accuracy_ok": bool(acc_ok),
        },
        f"paced_rho{paced['rho']}_k{burst['k_slots']}": {
            "p50_rel_err": paced["rel_err"]["p50"],
            "p99_rel_err": paced["rel_err"]["p99"],
            "p999_rel_err": paced["rel_err"]["p999"],
            "p50_s": paced["wall"]["latency"]["p50"],
            "p99_s": paced["wall"]["latency"]["p99"],
            "drained": bool(paced["wall"]["drained"]),
            "model_ok": bool(paced["rel_err"]["p50"] <= 0.10
                             and paced["rel_err"]["p99"] <= 0.10),
        },
    }
    return {"serve": rows}


def jsonable(obj):
    """JSON-safe copy: numpy scalars/arrays to Python, non-finite floats
    to strings, keys starting with ``_`` dropped."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()
                if not str(k).startswith("_")}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return jsonable(obj.tolist())
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def main(argv=None) -> int:
    """CLI entry point (``python -m repro_torch.experiments.serve_exec``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.serve_exec",
        description="Serve-stage benchmark: continuous batcher under "
                    "open-loop load vs the M/G/k queueing perfmodel.")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--k-slots", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    spec = get_preset(args.preset)
    over = {}
    if args.requests is not None:
        over["serve_requests"] = args.requests
    if args.k_slots is not None:
        over["serve_k_slots"] = args.k_slots
    if args.n is not None:
        over["serve_n"] = args.n
    if args.seed is not None:
        over["seed"] = args.seed
    if over:
        spec = dataclasses.replace(spec, **over)

    serve = run_serve_exec(spec, device=args.device)
    record = bench_record(serve)
    record["detail"] = serve
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(jsonable(record), indent=1, sort_keys=True))

    burst, paced = serve["burst"], serve["paced"]
    print(f"burst: {burst['throughput_speedup']:.2f}x batched vs "
          f"sequential ({burst['batched']['throughput_rps']:.1f} rps, "
          f"occupancy {burst['batched']['occupancy_mean']:.2f})")
    print("paced: rel err p50 "
          f"{paced['rel_err']['p50']:.3f}, p99 "
          f"{paced['rel_err']['p99']:.3f}, p999 "
          f"{paced['rel_err']['p999']:.3f}")
    ok = (burst["throughput_speedup"] >= 2.0
          and paced["rel_err"]["p50"] <= 0.10
          and paced["rel_err"]["p99"] <= 0.10
          and all(c["match_1e10"] for c in serve["accuracy"]))
    print(f"serve gate: {'PASS' if ok else 'FAIL'} -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
