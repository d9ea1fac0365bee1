"""Campaign orchestration + CLI (the JAX package's
``experiments/campaign.py``).

``run_campaign`` wires the stages together:

  1. discrete-event Monte Carlo over (noise, P) cells — measured sync vs
     pipelined makespans (pure-wait regime AND phase-model-based hw
     variant per solver);
  2. fitting — the recorded wait samples through core/stats, classified
     best family vs injected family, parameter recovery;
  3. real execution on ``device`` (the card unless the caller asks for
     the CPU) — iteration-engine timing/residual-drift runs, wall-clock
     noise-injected many-rank repeats, and the fault, serve, ABFT,
     precision and geometry stages (spawned ranks for every many-rank
     solve, ``distributed/ranks.py``);
  4. validation — measured vs ``asymptotic_speedup``, folk-theorem 2x
     bound, exponential P=4 crossover, and each stage's gates;
  5. reporting — figures CSVs, ``campaign.json`` and ``REPORT.md``.

CLI::

  python -m repro_torch.experiments.campaign --preset smoke
  python -m repro_torch.experiments.campaign --preset paper \\
      --out-dir chiprun_out/campaign_paper --device cuda

Everything, the JSON included, is written under ``--out-dir`` (default
``chiprun_out/campaign/``, relative to the CWD); nothing lands beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.core.noise.simulator import (Hardware, SolverPhaseModel,
                                              predict_speedup)
from repro_torch.core.noise.traces import EX23_N
from repro_torch.experiments.fitting import fit_cell
from repro_torch.experiments.noise_sources import (
    injected_family,
    make_distribution,
    sample_np,
    scale_distribution,
)
from repro_torch.experiments.abft_exec import abft_jobs, bench_record
from repro_torch.experiments.abft_exec import abft_record as abft_record_of
from repro_torch.experiments.fault_exec import fault_jobs, fault_record
from repro_torch.experiments.geometry_exec import geometry_jobs
from repro_torch.experiments.geometry_exec import (
    geometry_record as geometry_record_of,
)
from repro_torch.experiments.precision_exec import (
    bench_record as precision_bench_record,
    precision_jobs,
)
from repro_torch.experiments.precision_exec import (
    precision_record as precision_record_of,
)
from repro_torch.experiments.report import (
    write_abft_csv,
    write_depth_csv,
    write_ecdf_csv,
    write_fault_csv,
    write_geometry_csv,
    write_json,
    write_precision_csv,
    write_report_md,
    write_runtimes_csv,
    write_serve_csv,
    write_speedup_csv,
    write_sync_csv,
)
from repro_torch.experiments.runner import (
    effective_trials,
    engine_jobs,
    measured_depth_makespans,
    measured_makespans,
    measured_s_sync_makespans,
    noisy_jobs,
    noisy_record,
    run_depth_exec,
    run_engine_exec,
    start_rank_jobs,
)
from repro_torch.experiments.spec import SOLVER_PAIRS, CampaignSpec, get_preset
from repro_torch.experiments.validation import (
    modeled_speedup,
    validate_abft_cells,
    validate_cells,
    validate_depth_cells,
    validate_fault_cells,
    validate_geometry_cells,
    validate_precision_cells,
    validate_s_sync_cells,
    validate_serve_cells,
)

DEFAULT_OUT = "chiprun_out/campaign"

# Coarse per-solver phase constants (vector-read multiples, reduction sync
# points) for the hw-adjusted variant: (classical partner, pipelined).
# CG/PIPECG match core/noise/simulator.ex23_models; CR adds the w = A u
# traffic; (P)GMRES uses restart-averaged orthogonalization traffic.
_PHASE_CONSTANTS = {
    "pipecg": ((6, 2), (14, 1)),
    "pipecr": ((8, 2), (16, 1)),
    "pgmres": ((10, 2), (12, 1)),
    # classical BiCGStab exposes FOUR reductions per iteration; the
    # pipelined variant fuses them into one overlapped Gram (and carries
    # ~2x the AXPY state) — the >2x s-sync ceiling family
    "pipebicgstab": ((10, 4), (18, 1)),
}

_INJECTED_PARAMS = {
    "uniform": {"a": 0.0, "b": 1.0},
    "exponential": {"loc": 0.0, "lambda": 1.0},
    "lognormal": {"mu": 0.0, "sigma": 1.0},
}


def _phase_models(solver: str, P: int, hw: Hardware):
    """(classical, pipelined) ``SolverPhaseModel`` pair for ``solver``."""
    (r_s, k_s), (r_p, k_p) = _PHASE_CONSTANTS[solver]
    def mk(r, k):
        return SolverPhaseModel(n=EX23_N, nnz_per_row=3, p=P, hw=hw,
                                n_vec_reads=r, n_reductions=k)
    return mk(r_s, k_s), mk(r_p, k_p)


def _discrete_cells(spec: CampaignSpec, dists: Dict, hw: Hardware,
                    device) -> tuple:
    """Stage 1: Monte-Carlo makespan measurement over the full grid
    (``hw`` prices the phase models, ``device`` evaluates quadratures)."""
    cells = []
    wait_samples: Dict[str, np.ndarray] = {}
    for ni, (noise, dist) in enumerate(dists.items()):
        for pi, P in enumerate(spec.shard_counts):
            seed = spec.seed + 7919 * ni + 104729 * pi
            mm = measured_makespans(dist, P, spec.iters, spec.trials,
                                    seed=seed, fit_samples=spec.fit_samples)
            if noise not in wait_samples:
                wait_samples[noise] = mm.waits
            modeled = modeled_speedup(dist, P, device=device)
            measured = mm.speedup
            sdist = scale_distribution(dist, spec.noise_scale)
            models = {s: _phase_models(s, P, hw) for s in spec.solvers}
            hw_meas_all = _hw_measured(spec, sdist, models, P, seed=seed + 31)
            for solver in spec.solvers:
                sync_m, pipe_m = models[solver]
                hw_pred = predict_speedup(sync_m, pipe_m, sdist, K=spec.iters,
                                          device=device)
                cells.append({
                    "noise": noise, "P": P, "solver": solver,
                    "partner": SOLVER_PAIRS[solver],
                    "measured_speedup": measured,
                    "modeled_speedup": modeled,
                    "rel_err": abs(measured - modeled) / modeled,
                    "hw_measured_speedup": hw_meas_all[solver],
                    "hw_modeled_speedup": hw_pred["speedup"],
                    "trials": mm.trials_effective, "iters": mm.iters,
                    "t_sync_mean": float(mm.t_sync.mean()),
                    "t_pipe_mean": float(mm.t_pipe.mean()),
                })
    return cells, wait_samples


def _depth_cells(spec: CampaignSpec, dists: Dict, device) -> list:
    """Depth-sweep stage: lag-l measured vs block-resync modeled speedups.

    One cell per (noise, P, l) over ``spec.depths`` x
    ``spec.depth_shard_counts``, with the reduction latency
    ``spec.depth_red_latency`` (wait-mean units) on the synchronized
    critical path — the latency-dominated regime where the paper's
    Eq. 6/7 depth term is live.  ``ceiling_speedup`` is the l -> inf
    Eq. 8 asymptote each column converges to.
    """
    from repro_torch.core.perfmodel import (depth_speedup_ceiling,
                                            modeled_depth_speedup)

    R = spec.depth_red_latency
    cells = []
    for ni, (noise, dist) in enumerate(dists.items()):
        for pi, P in enumerate(spec.depth_shard_counts):
            seed = spec.seed + 15013 * ni + 27967 * pi
            ceiling = depth_speedup_ceiling(dist, P, red_latency=R,
                                            device=device)
            for l in spec.depths:
                mm = measured_depth_makespans(
                    dist, P, spec.iters, spec.trials, l, R, seed=seed)
                cells.append({
                    "noise": noise, "P": P, "l": l,
                    "measured_speedup": mm.speedup,
                    "modeled_speedup": modeled_depth_speedup(
                        dist, P, l, red_latency=R, seed=seed + l,
                        device=device),
                    "ceiling_speedup": float(ceiling),
                    "red_latency": R,
                    "trials": mm.trials_effective, "iters": mm.iters,
                    "t_sync_mean": mm.t_sync, "t_pipe_mean": mm.t_pipe,
                })
    return cells


def _s_sync_cells(spec: CampaignSpec, dists: Dict, device) -> list:
    """s-sync sweep stage: measured vs modeled sync-count speedups.

    One cell per (noise, P, s) over ``spec.sync_counts`` x
    ``spec.sync_shard_counts`` with the reduction latency
    ``spec.sync_red_latency`` on every synchronized sync point — the
    regime where the sync count of the classical solver (2 for CG, 4 for
    BiCGStab) bounds the pipelined speedup at s instead of the folk 2x
    (``core/perfmodel/sync.py``; the four-sync measured cells are the
    campaign's rendering of the p-BiCGStab opportunity).
    """
    from repro_torch.core.perfmodel import s_sync_ceiling, s_sync_speedup

    R = spec.sync_red_latency
    cells = []
    for ni, (noise, dist) in enumerate(dists.items()):
        for pi, P in enumerate(spec.sync_shard_counts):
            seed = spec.seed + 31013 * ni + 52583 * pi
            for s in spec.sync_counts:
                mm = measured_s_sync_makespans(
                    dist, P, spec.iters, spec.trials, s, R, seed=seed)
                cells.append({
                    "noise": noise, "P": P, "s": s,
                    "measured_speedup": mm.speedup,
                    "modeled_speedup": s_sync_speedup(
                        dist, P, s, red_latency=R, seed=seed + s,
                        device=device),
                    "ceiling_speedup": s_sync_ceiling(s),
                    "red_latency": R,
                    "trials": mm.trials_effective, "iters": mm.iters,
                    "t_sync_mean": mm.t_sync, "t_pipe_mean": mm.t_pipe,
                })
    return cells


def _hw_measured(spec: CampaignSpec, sdist, models: Dict, P: int,
                 seed: int) -> Dict[str, float]:
    """Discrete-event speedup with the phase model's compute bases.

    Synchronized step: max_p(t_compute + W_p) + n_red * t_red (reductions
    on the critical path).  Pipelined step per process: max(t_compute +
    W_p, t_red) — the overlapped reduction only matters when it outlasts
    compute + wait.  One waiting-time stream is drawn per (noise, P) and
    every solver's statistics are accumulated from it (only the scalar
    bases differ between solvers); trials are reduced (the hw variant is
    a secondary, per-solver diagnostic).
    """
    rng = np.random.default_rng(seed)
    trials = effective_trials(max(16, spec.trials // 4), P)
    acc_sync = {s: np.zeros(trials) for s in models}
    acc_proc = {s: np.zeros((trials, P)) for s in models}
    chunk = max(1, 2_000_000 // max(trials * P, 1))
    done = 0
    while done < spec.iters:
        kb = min(chunk, spec.iters - done)
        w = sample_np(sdist, rng, (trials, kb, P))
        for s, (sync_m, pipe_m) in models.items():
            tr = sync_m.t_reduction()
            acc_sync[s] += ((sync_m.t_compute() + w).max(axis=2).sum(axis=1)
                            + kb * sync_m.n_reductions * tr)
            acc_proc[s] += np.maximum(pipe_m.t_compute() + w,
                                      pipe_m.n_reductions * tr).sum(axis=1)
        done += kb
    return {s: float(acc_sync[s].mean() / acc_proc[s].max(axis=1).mean())
            for s in models}


def _sharded_exec_summary(spec: CampaignSpec, engine_exec, dists,
                          device) -> list:
    """Measured sharded-fused speedup vs the §3 asymptotic model.

    For every ``engine="sharded_fused"`` execution cell, the measured
    speedup is the naive-engine per-iteration wall time of the same
    solver divided by the sharded one; the modeled column is
    ``perfmodel.asymptotic_speedup`` of the campaign's execution noise at
    P = the cell's rank count (1.0 at one rank — the model's E[max of
    1]/mu).  A sharded-engine change claims a speedup only if this table
    says so.
    """
    from repro_torch.core.perfmodel import asymptotic_speedup

    naive = {c["solver"]: c for c in engine_exec if c["engine"] == "naive"}
    dist = dists.get(spec.exec_noise)
    out = []
    for c in engine_exec:
        if c["engine"] != "sharded_fused":
            continue
        base = naive.get(c["solver"])
        if base is None:
            continue
        P = int(c.get("n_shards", 1))
        modeled = (asymptotic_speedup(dist, P, method="auto", device=device)
                   if (dist is not None and P > 1) else 1.0)
        out.append({
            "solver": c["solver"], "n": c["n"], "n_shards": P,
            "per_iter_us": c["per_iter_us"],
            "naive_per_iter_us": base["per_iter_us"],
            "measured_speedup": base["per_iter_us"] / c["per_iter_us"],
            "modeled_asymptotic_speedup": float(modeled),
            "noise": spec.exec_noise,
        })
    return out


def _s_sync_predict_record(spec: CampaignSpec, hw: Hardware, device
                           ) -> Dict:
    """``predict_speedup`` in the latency-dominated phase-model regime.

    Evaluated at the paper's Piz Daint scale (P = 8192, where the
    reduction tree latency dwarfs the per-chip compute) with vanishing
    noise: the four-sync BiCGStab pair must report a modeled ceiling
    above the folk-theorem 2x — the headline the pipebicgstab work
    banks on.  Deterministic (no Monte-Carlo term survives the tiny
    noise scale).
    """
    from repro_torch.core.noise.simulator import ex23_models

    P = 8192
    models = ex23_models(p=P, hw=hw)
    tiny = scale_distribution(make_distribution("exponential",
                                                seed=spec.seed), 1e-12)
    four = predict_speedup(models["bicgstab"], models["pipebicgstab"],
                           tiny, K=spec.iters, device=device)
    two = predict_speedup(models["cg"], models["pipecg"], tiny,
                          K=spec.iters, device=device)
    return {"P": P, "bicgstab": four["speedup"], "cg": two["speedup"],
            "t_reduction": four["t_reduction"]}


def _acceptance(spec: CampaignSpec, cells, wait_fits,
                depth_validation=None, sync_validation=None,
                fault_validation=None,
                serve_validation=None,
                abft_validation=None,
                precision_validation=None,
                geometry_validation=None) -> Dict[str, bool]:
    """The campaign's acceptance checks, evaluated on its data."""
    exp_cells = [c for c in cells if c["noise"] == "exponential"]
    uni_cells = [c for c in cells if c["noise"] == "uniform"]
    checks: Dict[str, bool] = {}
    if exp_cells:
        big = [c for c in exp_cells if c["P"] >= 4]
        checks["exponential measured speedup > 2x for all P >= 4"] = (
            bool(big) and all(c["measured_speedup"] > 2.0 for c in big))
    if uni_cells:
        checks["uniform measured speedup < 2x at every P (folk bound)"] = all(
            c["measured_speedup"] < 2.0 for c in uni_cells)
    checks["fitted family matches injected for every closed-form noise"] = all(
        fit["family_match"] for fit in wait_fits.values()
        if fit["family_match"] is not None)
    if depth_validation:
        checks["depth sweep: measured speedup monotone in l"] = all(
            row["measured_monotone"] for row in depth_validation.values())
        # the l>1 crossover: wherever the sweep reaches the Eq. 8 ceiling
        # fraction, it does so at a depth strictly greater than 1 (-1 =
        # even the deepest swept l is still latency-bound — recorded too)
        checks["depth sweep: ceiling fraction reached only at l > 1"] = all(
            row["crossover_l_measured"] != 1
            for row in depth_validation.values())
        checks["depth sweep: block-resync model lower-bounds measured"] = all(
            row["model_is_lower_bound"]
            for row in depth_validation.values())
    if sync_validation:
        rows = [row for key, row in sync_validation.items()
                if key != "predict_speedup_latency_regime"]
        checks["s-sync sweep: four-sync speedup > 2x measured AND "
               "modeled (beyond the folk bound)"] = all(
            row["four_sync_measured_gt_2x"]
            and row["four_sync_modeled_gt_2x"] for row in rows)
        checks["s-sync sweep: measured speedup monotone in sync count"] = (
            all(row["measured_monotone_in_s"] for row in rows))
        pred = sync_validation.get("predict_speedup_latency_regime")
        if pred:
            checks["predict_speedup: four-sync phase model > 2x in the "
                   "latency regime"] = pred["bicgstab"] > 2.0
    if fault_validation:
        rows = list(fault_validation.values())
        checks["fault stage: every injected fault detected, recovered, "
               "and converged"] = all(
            row["recovered"] and row["converged"] and row["accuracy_ok"]
            for row in rows)
        checks["fault stage: recovery overhead within 2x of the resync "
               "lower bound"] = all(
            row["within_bound_factor"] for row in rows)
    if serve_validation:
        checks["serve: batched throughput >= 2x sequential one-shot"] = (
            serve_validation["throughput_ge_2x"])
        checks["serve: queueing-model p50/p99 within the campaign "
               "tolerance"] = serve_validation["model_within_tolerance"]
        checks["serve: mid-flight-retired solutions match solo to "
               "1e-10"] = serve_validation["accuracy_ok"]
        checks["serve: queue drained with every request converged"] = (
            serve_validation["drained"]
            and serve_validation["all_converged"])
    if abft_validation:
        rows = list(abft_validation.values())
        checks["abft: zero false positives on clean solves"] = all(
            not row["false_positive"] for row in rows)
        checks["abft: supra-threshold corruption detected in the "
               "modeled window, sub-threshold never trips"] = all(
            row["detection_ok"] for row in rows)
        rec = [row for row in rows if "recovery_ok" in row]
        checks["abft: elastic recovery driven by the checksum fast "
               "path"] = bool(rec) and all(row["recovery_ok"]
                                           for row in rec)
    if precision_validation:
        cells_p = [row for key, row in precision_validation.items()
                   if "/" in key]
        checks["precision: safe policies within the Cools accuracy "
               "floor, unsafe demonstrators outside it"] = all(
            row["precision_ok"] for row in cells_p)
        nef = precision_validation.get("noef_vs_ef")
        if nef:
            checks["precision: int8 wire without error feedback "
                   "measurably degrades the plateau"] = nef["degrades"]
        order = precision_validation.get("split_phase")
        if order:
            checks["precision: split-phase overlap preserved under the "
                   "compressed wire"] = order["overlap_ok"]
        conv = precision_validation.get("regime_conversion")
        if conv:
            checks["precision: model predicts the bandwidth->latency "
                   "regime conversion for bf16 storage"] = (
                conv["converted"])
    if geometry_validation:
        rows = [row for key, row in geometry_validation.items()
                if key != "best_grid"]
        checks["geometry: split-phase overlap (one all-reduce per body) "
               "for every format x grid"] = all(
            row["one_all_reduce"] and row["overlap_ok"] for row in rows)
        checks["geometry: strip sends per iteration match the "
               "surface-to-volume message model"] = all(
            row["strip_msgs_match"] for row in rows)
        checks["geometry: every sharded solve matches the single-device "
               "reference"] = all(row["accuracy_ok"] for row in rows)
        bg = geometry_validation.get("best_grid")
        if bg:
            checks["geometry: comm model's best grid minimizes halo "
                   "elements over the swept grids"] = (
                bg["matches_comm_model"])
    return checks


def run_campaign(spec: CampaignSpec, out_dir=None, json_out=None,
                 skip_exec: bool = False, *, device="cuda",
                 exec_shards: int = 4, hw: Optional[Hardware] = None,
                 launches: Optional[Dict[str, Dict[str, int]]] = None,
                 stage_seconds: Optional[Dict[str, float]] = None) -> Dict:
    """Run the full campaign; writes artifacts and returns the record.

    ``out_dir`` defaults to ``chiprun_out/campaign`` (relative to the
    CWD); the JSON goes to ``out_dir / "campaign.json"`` unless
    ``json_out`` names another path.  ``skip_exec`` skips stage 3 (real
    solver runs) for fast interactive use; the emitted report then has
    empty exec tables.  ``device`` runs the solves and evaluates the
    model's quadratures (the card unless the caller asks for the CPU);
    the many-rank execution cells run on ``exec_shards`` spawned ranks
    (the JAX package uses its local devices).  ``hw`` prices the phase
    models (default the port's H100 ``Hardware()``).  ``launches`` and
    ``stage_seconds``, when given, receive each stage's kernel launches
    (in this process and in its ranks) and wall seconds, by stage name.
    """
    t_start = time.time()
    out_dir = Path(DEFAULT_OUT if out_dir is None else out_dir)
    json_out = out_dir / "campaign.json" if json_out is None else json_out
    hw = Hardware() if hw is None else hw
    seconds: Dict[str, float] = ({} if stage_seconds is None
                                 else stage_seconds)

    def stage(name):
        return _Stage(name, launches, seconds)

    dists = {name: make_distribution(name, seed=spec.seed, device=device)
             for name in spec.noises}

    # 3 (started first). Every many-rank cell of every execution stage
    # runs in one spawn per world size (rank jobs, experiments/runner.py).
    # The ranks start up beside the host stages 1 and 2 and run their
    # jobs once those are done, so nothing they time shares the host with
    # this process.  The one-device cells and the serve stage run in this
    # process once the ranks are done
    engine_exec = []
    sharded_exec: list = []
    depth_exec: list = []
    noisy_exec: Dict[str, Dict] = {}
    runtime_fits: Dict[str, Dict] = {}
    fault_cells: list = []
    serve_record: Dict = {}
    abft_record: Dict = {}
    precision_record: Dict = {}
    geometry_record: Dict = {}
    if not skip_exec:
        jobs = {
            "engine": engine_jobs(spec.exec_solvers, spec.engines,
                                  spec.exec_n, spec.exec_maxiter,
                                  spec.exec_repeats, exec_shards),
            "noisy": noisy_jobs(spec.exec_solvers, dists[spec.exec_noise],
                                spec.noise_scale, spec.exec_n,
                                spec.exec_maxiter, spec.exec_repeats,
                                spec.seed, exec_shards),
            # 3b. fault injection: real shard-loss recovery, measured
            # against the resync model's bound
            "fault": fault_jobs(spec) if spec.fault_kinds else [],
            # 3d. ABFT: detection coverage of the carried in-flight
            # detectors (corruption magnitude x solver sweep)
            "abft": abft_jobs(spec),
            # 3e. precision: mixed-precision policies against the Cools
            # attainable-accuracy floors (policy x solver sweep)
            "precision": precision_jobs(spec),
            # 3f. geometry: operator format x process grid x noise sweep,
            # gated on the surface-to-volume communication model
            "geometry": geometry_jobs(spec),
        }
        running = start_rank_jobs(
            [j for js in jobs.values() for j in js], device)

    try:
        # 1. discrete-event measurement grid (+ the depth-l and s-sync
        # sweeps)
        with stage("discrete"):
            cells, wait_samples = _discrete_cells(spec, dists, hw, device)
            depth_cells = _depth_cells(spec, dists, device)
            sync_cells = _s_sync_cells(spec, dists, device)

        # 2. fitting round-trip on the recorded wait samples
        wait_fits: Dict[str, Dict] = {}
        for noise, waits in wait_samples.items():
            fit = fit_cell(waits, name=noise)
            inj = injected_family(noise)
            fit["injected_family"] = inj
            # None = recorded trace, round-trip check not applicable
            fit["family_match"] = ((fit["best_family"] == inj) if inj
                                   else None)
            fit["injected_params"] = _INJECTED_PARAMS.get(noise)
            wait_fits[noise] = fit
    except BaseException:
        if not skip_exec:
            running.cancel()
        raise

    if not skip_exec:
        # the rank jobs run now, with this process waiting
        done = iter(running.result(launches, seconds))
        outs = {name: [next(done) for _ in js] for name, js in jobs.items()}

        with stage("engine"):
            engine_exec = run_engine_exec(
                spec.exec_solvers, spec.engines, spec.exec_n,
                spec.exec_maxiter, repeats=spec.exec_repeats, device=device,
                n_shards=exec_shards, sharded_outs=outs["engine"])
        sharded_exec = _sharded_exec_summary(spec, engine_exec, dists,
                                             device)
        with stage("depth"):
            depth_exec = run_depth_exec(
                spec.depths, spec.exec_n, spec.depth_exec_maxiter,
                repeats=max(2, spec.exec_repeats // 2), device=device)
        noisy_exec = noisy_record(outs["noisy"])
        for solver, cell in noisy_exec.items():
            runtime_fits[solver] = fit_cell(cell["run_times"],
                                            name=f"runtime:{solver}")
        if spec.fault_kinds:
            fault_cells = fault_record(spec, outs["fault"])["cells"]
        # 3c. serve stage: the continuous batcher under open-loop load,
        # measured against the M/G/k queueing extension of the perfmodel
        if spec.serve_requests > 0:
            from repro_torch.experiments.serve_exec import run_serve_exec
            with stage("serve"):
                serve_record = run_serve_exec(spec, device=device)
        abft_record = abft_record_of(spec, outs["abft"])
        if spec.precision_policies and spec.precision_solvers:
            precision_record = precision_record_of(
                spec, outs["precision"], device=device)
        geometry_record = geometry_record_of(spec, outs["geometry"])

    # 4. validation
    validation = validate_cells(cells, dists, device=device)
    validation["depth"] = validate_depth_cells(depth_cells)
    validation["s_sync"] = validate_s_sync_cells(sync_cells)
    validation["s_sync"]["predict_speedup_latency_regime"] = (
        _s_sync_predict_record(spec, hw, device))
    validation["fault"] = validate_fault_cells(fault_cells)
    validation["serve"] = validate_serve_cells(serve_record)
    validation["abft"] = validate_abft_cells(abft_record.get("cells", []))
    validation["precision"] = validate_precision_cells(precision_record)
    validation["geometry"] = validate_geometry_cells(
        geometry_record.get("cells", []))
    validation["acceptance"] = _acceptance(spec, cells, wait_fits,
                                           validation["depth"],
                                           validation["s_sync"],
                                           validation["fault"],
                                           validation["serve"],
                                           validation["abft"],
                                           validation["precision"],
                                           validation["geometry"])

    result = {
        "spec": dataclasses.asdict(spec),
        "cells": cells,
        "depth_cells": depth_cells,
        "sync_cells": sync_cells,
        "wait_fits": wait_fits,
        "engine_exec": engine_exec,
        "sharded_exec": sharded_exec,
        "depth_exec": depth_exec,
        "noisy_exec": noisy_exec,
        "runtime_fits": runtime_fits,
        "fault_cells": fault_cells,
        "serve": serve_record,
        "abft_cells": abft_record.get("cells", []),
        # flat per-cell ABFT detection metrics
        "abft": bench_record(abft_record)["abft"],
        "precision_cells": precision_record.get("cells", []),
        "precision_model": precision_record.get("model", {}),
        # flat per-cell precision metrics
        "precision": precision_bench_record(precision_record)["precision"],
        "geometry_cells": geometry_record.get("cells", []),
        # flat per-cell recovery metrics
        "recovery": {
            f"{c['kind']}_rate{c['rate']}_P{c['n_shards']}": {
                "overhead_iters": c["overhead_iters"],
                "bound_iters": c["bound_iters"],
                "overhead_ratio": c["overhead_ratio"],
                "recovered": c["recovered"],
                "converged": c["converged"],
            }
            for c in fault_cells if not c.get("skipped")
        },
        "validation": validation,
        "elapsed_s": time.time() - t_start,
    }

    # 5. artifacts
    write_speedup_csv(out_dir, cells)
    write_depth_csv(out_dir, depth_cells)
    write_sync_csv(out_dir, sync_cells)
    if fault_cells:
        write_fault_csv(out_dir, fault_cells)
    if serve_record:
        write_serve_csv(out_dir, serve_record)
    if abft_record.get("cells"):
        write_abft_csv(out_dir, abft_record["cells"])
    if precision_record.get("cells"):
        write_precision_csv(out_dir, precision_record["cells"])
    if geometry_record.get("cells"):
        write_geometry_csv(out_dir, geometry_record["cells"])
    for noise, waits in wait_samples.items():
        write_ecdf_csv(out_dir, noise, waits)
    if noisy_exec:
        write_runtimes_csv(out_dir, noisy_exec)
    write_json(json_out, result)
    write_report_md(out_dir, result)
    return result


class _Stage:
    """Adds a stage's in-process wall seconds and kernel launches into
    ``seconds[name]`` and ``launches[name]`` (its ranks' are added by
    ``run_rank_jobs``)."""

    def __init__(self, name: str, launches, seconds):
        self.name, self.launches, self.seconds = name, launches, seconds

    def __enter__(self) -> None:
        from repro_torch.kernels import ops
        self.before = ops.launch_counts()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import ops
        self.seconds[self.name] = (self.seconds.get(self.name, 0.0)
                                   + time.perf_counter() - self.t0)
        if self.launches is not None:
            after = ops.launch_counts()
            mine = self.launches.setdefault(self.name, {})
            for k in after:
                mine[k] = mine.get(k, 0) + after[k] - self.before[k]


def main(argv=None) -> int:
    """CLI entry point (``python -m repro_torch.experiments.campaign``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.campaign",
        description="Noise-injected Monte-Carlo solver campaign: measured "
                    "vs modeled pipelined-Krylov speedups.")
    ap.add_argument("--preset", default="smoke",
                    help="campaign preset: smoke | paper")
    ap.add_argument("--out-dir", default=DEFAULT_OUT,
                    help=f"artifact directory (default: {DEFAULT_OUT})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    ap.add_argument("--exec-shards", type=int, default=4,
                    help="ranks of the many-rank execution cells")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the preset's base seed")
    ap.add_argument("--skip-exec", action="store_true",
                    help="skip the real solver execution stage")
    ap.add_argument("--fault-shards", type=int, nargs="+", default=None,
                    help="override the preset's fault-stage shard counts "
                         "(a kill at P = 8 leaves 7 ranks, which cannot "
                         "share the paper preset's fault_n = 240 rows)")
    args = ap.parse_args(argv)

    spec = get_preset(args.preset)
    if args.seed is not None:
        spec = dataclasses.replace(spec, seed=args.seed)
    if args.fault_shards is not None:
        spec = dataclasses.replace(spec,
                                   fault_shard_counts=tuple(args.fault_shards))
    seconds: Dict[str, float] = {}
    result = run_campaign(spec, out_dir=args.out_dir,
                          skip_exec=args.skip_exec, device=args.device,
                          exec_shards=args.exec_shards,
                          stage_seconds=seconds)

    acc = result["validation"]["acceptance"]
    for check, ok in acc.items():
        print(f"{'PASS' if ok else 'FAIL'}: {check}")
    print("stage seconds: " + " ".join(f"{k}={v:.2f}"
                                       for k, v in seconds.items()))
    print(f"campaign `{spec.name}` done in {result['elapsed_s']:.1f}s; "
          f"cells={len(result['cells'])} -> {args.out_dir}")
    return 0 if all(acc.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
