"""Campaign precision stage: mixed-precision attainable-accuracy floors
(the JAX package's ``experiments/precision_exec.py``).

Sweeps ``PrecisionPolicy`` preset x solver over REAL many-rank sharded
solves, all cells in one spawn of ``spec.precision_shards`` ranks
(``distributed/ranks.py``; the JAX package forces host devices in a
subprocess).  Per cell every rank runs the sharded
solve to its accuracy plateau (no tolerance, fixed iteration budget) and
measures the TRUE residual ``|b - A x| / |b|`` from the returned
solution — the carried recurrence residual UNDERFLOWS to exact zero past
the storage floor, so it cannot gate anything here.

The gate is the attainable-accuracy floor of Cools et al.
(arXiv:1804.02962 pipelined-CG rounding-error analysis; arXiv:1809.01948
for p-BiCGStab): a pipelined recurrence carried at storage precision
with unit roundoff ``eps`` plateaus at ``C_solver * eps`` relative true
residual on a well-conditioned operator, where the amplification
constant ``C_solver`` is a property of the RECURRENCE — measured here
at ~1.2 for p-CG and ~10-19 for p-BiCGStab (its two-SpMV recurrence;
the constant is the same order across fp64 and bf16 storage, which is
what makes it a solver constant and not a dtype artifact).  The stage
checks each cell against ``FLOOR_FACTORS[solver] * eps_storage`` and
classifies three expectations:

* SAFE policies (fp32; bf16 storage; bf16 + int8 halo WIRE with error
  feedback) must land within the solver's floor;
* DEGRADED demonstrators must land within the floor but measurably
  above their error-feedback partner — int8 wire WITHOUT error feedback
  (the quantization bias enters the recurrence; at 128-lane strips the
  measured plateau sits ``NOEF_MIN_RATIO``+ above the EF plateau, and
  error feedback recovers the plain-bf16 floor to within ~5%);
* UNSAFE demonstrators must land outside the floor — int8 on the
  carried GRAM psum (consumed once per iteration, corrupting
  alpha/beta directly: the solve freezes ~1e6 eps off; the measured
  reason ``PrecisionPolicy`` splits ``wire`` from ``wire_gram``).

The bf16+int8-wire pipecg cell also records its order (the JAX package
reads the same invariant from compiled HLO, which the port has not,
ROADMAP.md H5): ``overlap.split_phase_ok`` on every rank and one
all-reduce per iteration — compressing the strips must not break the
split-phase window.  The stage
adds the perfmodel side: ``predict_speedup(precision=...)`` at a
bandwidth-dominated operating point, where shrinking storage/wire bytes
converts the pipelined step into the latency-dominated regime
(``pipe_latency_bound`` flips to 1) and the predicted speedup crosses
the fp32 baseline.

CLI (on the card; ``--device cpu`` runs the plain versions on the host;
the campaign embeds the same rows as its record's ``precision`` key)::

    PYTHONPATH=src python -m repro_torch.experiments.precision_exec \\
        [--preset smoke] [--seed 0] [--out chiprun_out/precision_exec.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

DEFAULT_OUT = "chiprun_out/precision_exec.json"

#: attainable-accuracy floor per solver, in storage-eps units (the Cools
#: amplification constant with ~2x headroom).  Measured plateaus on the
#: stage operators (the JAX package's Pallas kernels): p-CG bf16 1.20 eps
#: / +int8wire(EF) 1.26 eps (floor 2.0); p-BiCGStab fp64 18.8 eps_fp32
#: and bf16 10.6 eps_bf16 — the two-SpMV recurrence's ~10-19x
#: amplification, budget-independent once saturated — so its floor is
#: 32.  The UNSAFE demonstrator (int8 Gram) lands ~3e6 eps off: orders
#: outside any floor.  (The port's p-BiCGStab plateau is H8's drift past
#: convergence: ROADMAP.md H13.)
FLOOR_FACTORS = {"pipecg": 2.0, "pipebicgstab": 32.0}

#: a DEGRADED cell must land at least this factor above its
#: error-feedback partner's plateau (measured no-EF/EF ratio 1.151 at
#: 128-lane strips; 1.05 leaves ~10% headroom)
NOEF_MIN_RATIO = 1.05

#: solver -> policies expected to sit WITHIN the floor
SAFE_POLICIES = {
    "pipecg": ("fp32", "bf16", "bf16_int8wire"),
    "pipebicgstab": ("fp32", "bf16"),
}

#: solver -> policies expected within the floor but measurably above
#: their error-feedback partner (see NOEF_MIN_RATIO)
DEGRADED_POLICIES = {
    "pipecg": ("bf16_int8wire_noef",),
    "pipebicgstab": (),
}

#: policies each solver sweeps (p-BiCGStab stops at the storage ladder:
#: p-CG's cells already pin the wire-compression safety contract, and
#: each p-BiCGStab cell costs two SpMVs per iteration)
SOLVER_POLICIES = {
    "pipecg": None,          # None = the full spec.precision_policies
    "pipebicgstab": ("fp32", "bf16"),
}


def _band(n: int, offsets, diag: float, device):
    """DIA bands: ``diag`` on the main band, -1 elsewhere (zero outside
    the matrix)."""
    from repro_torch.core.krylov.operators import DiaMatrix

    i = np.arange(n)
    bands = np.zeros((len(offsets), n))
    for k, o in enumerate(offsets):
        if o == 0:
            bands[k] = diag
        else:
            bands[k] = np.where((i + o >= 0) & (i + o < n), -1.0, 0.0)
    return DiaMatrix(offsets=tuple(offsets),
                     bands=torch.as_tensor(bands, device=device))


def _dd_pentadiagonal(n: int, halo: int = 128, device="cuda"):
    """Diagonally dominant pentadiagonal band, half-bandwidth ``halo``.

    SPD with small condition number: the precision floors are ROUNDING
    limits, and an ill-conditioned operator hides them behind the
    ``kappa * eps`` conditioning limit (bf16 cannot converge at all once
    ``kappa`` exceeds ``1/eps_bf16`` ~ 256).  The +-128 offsets give the
    int8 halo strips real payload (128 lanes x 2 sides x 2 vectors) —
    the quantization surface where the no-error-feedback bias becomes
    measurable (the no-EF/EF plateau ratio is 1.04 at 32-lane strips vs
    1.15 at 128).
    """
    return _band(n, (-halo, -1, 0, 1, halo), 4.1, device)


def _spd_tridiagonal(n: int, device="cuda"):
    """Shifted tridiagonal Laplacian (diag 3): the p-BiCGStab operator.

    The sharded p-BiCGStab recurrence BREAKS DOWN (residual freeze, far
    above any rounding floor) on the pentadiagonal operator with a
    Gaussian RHS — measured, budget-independent — while on this
    operator with ``b = ones`` it converges to its ``C_solver * eps``
    plateau at every storage precision, which is the quantity the stage
    pins.
    """
    return _band(n, (-1, 0, 1), 3.0, device)


def _true_residual(offsets, bands, x, b) -> float:
    """``|b - A x| / |b|`` in float64 numpy (DIA convention)."""
    bands = np.asarray(bands, np.float64)
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    n = x.size
    y = np.zeros(n)
    i = np.arange(n)
    for k, o in enumerate(offsets):
        ok = (i + o >= 0) & (i + o < n)
        y[ok] += bands[k][ok] * x[(i + o)[ok]]
    return float(np.linalg.norm(b - y) / np.linalg.norm(b))


def problems(n: int, maxiter: int, seed: int, device="cuda") -> Dict:
    """Per-solver (operator, RHS, iteration budget): p-CG on the
    wide-halo pentadiagonal band with a Gaussian RHS (numpy, seeded
    ``seed + 1``); p-BiCGStab on the shifted tridiagonal Laplacian with
    b = ones at 1.5x the budget, past the saturation knee of its
    drifting bf16 plateau."""
    rng = np.random.default_rng(seed + 1)
    return {
        "pipecg": (_dd_pentadiagonal(n, device=device),
                   torch.as_tensor(rng.standard_normal(n), device=device),
                   maxiter),
        "pipebicgstab": (_spd_tridiagonal(n, device=device),
                         torch.ones(n, dtype=torch.float64, device=device),
                         (3 * maxiter) // 2),
    }


def precision_rank_cells(rank: int, world: int, cfg: Dict,
                         device: str = "cuda") -> Dict:
    """Rank body: every cell of ``cfg`` on the whole group; rank 0 holds
    the classified cells, every rank the order check of the
    bf16+int8-wire cell and its kernel launches."""
    import torch.distributed as dist

    from repro_torch.core.krylov.bicgstab import pipebicgstab
    from repro_torch.core.krylov.cg import pipecg
    from repro_torch.core.krylov.distributed import distributed_solve
    from repro_torch.core.krylov.options import PrecisionPolicy, SolverOptions
    from repro_torch.distributed.overlap import (CountingRecorder,
                                                 split_phase_ok)
    from repro_torch.kernels import ops

    n = int(cfg["n"])
    P = world
    maxiter = int(cfg["maxiter"])
    probs = problems(n, maxiter, int(cfg["seed"]), device)
    solver_fns = {"pipecg": pipecg, "pipebicgstab": pipebicgstab}
    ops.reset_launch_counts()
    cells: List[Dict] = []
    order: Dict = {}
    for cell in cfg["cells"]:
        solver, policy_name = cell["solver"], cell["policy"]
        A, b, iters = probs[solver]
        policy = PrecisionPolicy.from_name(policy_name)
        opts = SolverOptions(maxiter=iters, precision=policy,
                             engine="sharded_fused")
        watch = solver == "pipecg" and policy_name == "bf16_int8wire"
        rec = CountingRecorder() if watch else None
        res = distributed_solve(solver_fns[solver], A, b, None,
                                options=opts, recorder=rec)
        if watch:
            loop = rec.loop_counts()
            mine = torch.tensor(
                [float(split_phase_ok(rec.events, iters)),
                 float(loop["issues"] + loop["blocking"]) / iters],
                dtype=torch.float64)
            worst = mine.clone()
            dist.all_reduce(mine[:1], op=dist.ReduceOp.MIN)
            dist.all_reduce(worst[1:], op=dist.ReduceOp.MAX)
            order = {"overlap_ok": bool(mine[0] == 1.0),
                     "all_reduces_per_iter": float(worst[1]),
                     "iterations": iters}
        true_res = _true_residual(A.offsets, A.bands.cpu().numpy(),
                                  res.x.double().cpu().numpy(),
                                  b.cpu().numpy())
        eps = policy.storage_eps
        floor = FLOOR_FACTORS[solver] * eps
        cells.append({
            **cell,
            "iters": int(res.iters),
            "true_res_rel": true_res,
            "eps_storage": float(eps),
            "floor_rel": float(floor),
            "res_over_eps": true_res / eps,
            "within_floor": bool(true_res <= floor),
            "storage_words": float(policy.storage_words),
            "wire_words": float(policy.wire_words),
            "skipped": False,
        })
    _classify(cells)
    if order:
        # the split-phase window must hold on every rank
        order["overlap_ok"] = bool(order["overlap_ok"]
                                   and order["all_reduces_per_iter"] == 1)
    return {"cells": cells, "order_bf16_int8wire": order,
            "n": n, "shards": P, "maxiter": maxiter,
            "floor_factors": dict(FLOOR_FACTORS),
            "noef_min_ratio": NOEF_MIN_RATIO,
            "launches": ops.launch_counts()}


def _classify(cells: List[Dict]) -> None:
    """Annotate each measured cell with its ``precision_ok`` verdict.

    ``safe``: within the solver's floor.  ``unsafe``: outside it.
    ``degraded`` (int8 wire without error feedback): within the floor
    AND at least ``NOEF_MIN_RATIO`` above its error-feedback partner's
    plateau — the pin that error feedback buys a measurable accuracy
    improvement at equal wire bytes.
    """
    by_key = {(c["solver"], c["policy"]): c for c in cells}
    for c in cells:
        if c.get("skipped"):
            continue
        expect = c["expect"]
        if expect == "safe":
            c["precision_ok"] = bool(c["within_floor"])
        elif expect == "unsafe":
            c["precision_ok"] = bool(not c["within_floor"])
        else:                                   # degraded
            ef = by_key.get((c["solver"], "bf16_int8wire"))
            ok = bool(c["within_floor"]) and ef is not None \
                and not ef.get("skipped")
            if ok:
                c["noef_over_ef"] = (c["true_res_rel"]
                                     / max(ef["true_res_rel"], 1e-300))
                ok = c["noef_over_ef"] >= NOEF_MIN_RATIO
            c["precision_ok"] = bool(ok)


def stage_cells(spec) -> List[Dict]:
    """The (solver, policy) grid of ``spec`` with expected classes."""
    cells = []
    for solver in spec.precision_solvers:
        policies = SOLVER_POLICIES.get(solver) or spec.precision_policies
        policies = [p for p in policies if p in spec.precision_policies]
        safe = SAFE_POLICIES.get(solver, ("fp32",))
        degraded = DEGRADED_POLICIES.get(solver, ())
        for policy in policies:
            expect = ("safe" if policy in safe
                      else "degraded" if policy in degraded else "unsafe")
            cells.append({"solver": solver, "policy": policy,
                          "expect": expect,
                          "expect_safe": expect == "safe"})
    return cells


def model_cells(policies, P: int = 256, n: int = 50_000_000,
                halo: int = 32, hw=None, device="cuda") -> Dict[str, Dict]:
    """``predict_speedup(precision=...)`` at a bandwidth-bound point.

    A large-n, wide-halo pipecg pair under light exponential noise: at
    fp32 the pipelined step is bandwidth-dominated (sweep + halo bytes
    exceed the overlapped reduction, speedup < 1 against the 2-sync
    baseline); shrinking the carried-vector sweep to bf16 and the halo
    wire to int8 drops ``t_compute`` below the reduction floor —
    ``pipe_latency_bound`` flips and the predicted speedup crosses 1.
    The measured cells validate the ACCURACY side of each policy; this
    is the model's PERFORMANCE side of the same sweep.  ``hw`` (default
    the port's H100 ``Hardware()``) prices it; ``device`` evaluates its
    quadratures.
    """
    from repro_torch.core.noise.simulator import (Hardware, SolverPhaseModel,
                                                  predict_speedup)
    from repro_torch.core.perfmodel.distributions import Exponential

    sync = SolverPhaseModel(n=n, nnz_per_row=5, p=P, dtype_bytes=4,
                            n_vec_reads=6, n_reductions=2,
                            halo=halo, n_halo_vecs=2,
                            hw=Hardware() if hw is None else hw)
    pipe = dataclasses.replace(sync, n_vec_reads=14, n_reductions=1)
    noise = Exponential(lam=1.0 / 2e-6)   # 2 us mean per-step wait
    out: Dict[str, Dict] = {}
    for policy in policies:
        pred = predict_speedup(sync, pipe, noise, K=1, precision=policy,
                               device=device)
        out[policy] = {
            "speedup": float(pred["speedup"]),
            "t_pipe_compute": float(pred["t_pipe_compute"]),
            "t_pipe_halo": float(pred["t_pipe_halo"]),
            "t_reduction": float(pred["t_reduction"]),
            "pipe_latency_bound": float(pred["pipe_latency_bound"]),
        }
    return out


def precision_jobs(spec) -> List:
    """The stage's rank job (none without cells or when
    ``spec.precision_shards`` does not divide ``spec.precision_n``)."""
    from repro_torch.experiments.runner import RankJob

    cells = stage_cells(spec)
    if not cells or spec.precision_n % spec.precision_shards:
        return []
    return [RankJob("precision", spec.precision_shards,
                    precision_rank_cells,
                    {"n": spec.precision_n,
                     "maxiter": spec.precision_maxiter,
                     "seed": spec.seed, "cells": cells})]


def precision_record(spec, outs: List[List[Dict]], device="cuda") -> Dict:
    """The stage's record from its job's per-rank outputs, with the
    modeled ``predict_speedup`` cells (rank 0's split-phase flag is
    already the group's)."""
    cells = stage_cells(spec)
    if not cells:
        return {"cells": [], "model": {}, "order_bf16_int8wire": {}}
    if outs:
        record = {k: v for k, v in outs[0][0].items()
                  if k not in ("launches", "seconds")}
    else:
        record = {"cells": [{**c, "skipped": True,
                             "reason": f"{spec.precision_shards} ranks, "
                                       f"n={spec.precision_n}"}
                            for c in cells], "order_bf16_int8wire": {}}
    record["model"] = model_cells(tuple(spec.precision_policies),
                                  device=device)
    return record


def run_precision_exec(spec, device="cuda") -> Dict:
    """Run the precision stage of ``spec`` alone on
    ``spec.precision_shards`` spawned ranks (on ``device``, the card unless
    the caller asks for the CPU) and return its record with the modeled
    ``predict_speedup`` cells (the CLI; ``run_campaign`` runs
    :func:`precision_jobs` in its own spawn)."""
    from repro_torch.experiments.runner import run_rank_jobs

    return precision_record(spec, run_rank_jobs(precision_jobs(spec),
                                                device), device)


def bench_record(precision: Dict) -> Dict:
    """Flatten a precision-stage record into gate rows.

    ``precision_ok`` is each cell's ``_classify`` verdict (within the
    solver's floor for safe cells, outside it for unsafe demonstrators,
    floor + no-EF/EF ratio for degraded ones).  ``res_over_eps`` (lower
    is better) is only gated on safe/degraded cells — an unsafe cell's
    divergence magnitude is pinned by the flag, not by a relative band
    on a blow-up.
    """
    rows: Dict[str, Dict] = {}
    for c in precision.get("cells", []):
        if c.get("skipped"):
            continue
        key = f"{c['solver']}_{c['policy']}"
        rows[key] = {
            "expect": c["expect"],
            "expect_safe": bool(c["expect_safe"]),
            "within_floor": bool(c["within_floor"]),
            "precision_ok": bool(c["precision_ok"]),
            "storage_words": float(c["storage_words"]),
            "wire_words": float(c["wire_words"]),
        }
        if c["expect"] in ("safe", "degraded"):
            rows[key]["res_over_eps"] = float(c["res_over_eps"])
        if "noef_over_ef" in c:
            rows[key]["noef_over_ef"] = float(c["noef_over_ef"])
    order = precision.get("order_bf16_int8wire") or {}
    if "pipecg_bf16_int8wire" in rows:
        rows["pipecg_bf16_int8wire"]["split_phase_overlap"] = bool(
            order.get("overlap_ok"))
    return {"precision": rows}


def main(argv=None) -> int:
    """CLI entry point
    (``python -m repro_torch.experiments.precision_exec``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.precision_exec",
        description="Mixed-precision attainable-accuracy benchmark: "
                    "PrecisionPolicy x solver over sharded solves.")
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

    precision = run_precision_exec(spec, device=args.device)
    record = bench_record(precision)
    record["detail"] = precision
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_json(out, record)

    ok = all(r["precision_ok"] for r in record["precision"].values())
    for key, r in sorted(record["precision"].items()):
        print(f"{key}: expect={r['expect']} "
              f"within_floor={int(r['within_floor'])} "
              f"res_over_eps={r.get('res_over_eps', float('nan')):.3f} "
              f"ok={int(r['precision_ok'])}")
    print(f"precision stage: {'OK' if ok else 'FAILED'} "
          f"({len(record['precision'])} cells) -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
