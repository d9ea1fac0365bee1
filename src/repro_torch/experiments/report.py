"""Campaign reporting stage: CSV point files, the JSON record, REPORT.md
(the JAX package's ``experiments/report.py``; the port's campaign writes
everything under its out-dir, the JSON included).

Emitted artifacts (all schema-stable; tests assert on the headers):

* ``<out_dir>/figures/campaign_speedup.csv`` — measured vs modeled
  speedup per (noise, P, solver): the paper's speedup-curve figures.
* ``<out_dir>/figures/campaign_ecdf_<noise>.csv`` — ECDF of collected
  wait samples + fitted-family CDFs: the Figs. 5/6 analogue.
* ``<out_dir>/figures/campaign_runtimes.csv`` — noisy many-rank run
  times: the Table-1 raw data analogue.
* ``<out_dir>/figures/campaign_fault.csv`` — fault-stage recovery
  overheads vs the resync lower bound.
* ``<out_dir>/figures/campaign_serve.csv`` — serve-stage sojourn
  quantiles: wall clock vs batch-queue replay vs the M/G/k model.
* ``<out_dir>/figures/campaign_abft.csv`` — ABFT-stage detection
  coverage: in-flight detector latency per corruption magnitude.
* ``<out_dir>/campaign.json`` — the full machine-readable campaign
  record.
* ``<out_dir>/REPORT.md`` — self-contained measured-vs-modeled report.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.stats import ecdf_with_fits

SPEEDUP_CSV_HEADER = "noise,P,solver,measured,modeled,rel_err,hw_measured,hw_modeled"
ECDF_CSV_HEADER = "x,ecdf,uniform,exponential,exponential_shifted,lognormal"
RUNTIME_CSV_HEADER = "solver,run_index,seconds"
DEPTH_CSV_HEADER = "noise,P,l,measured,modeled,ceiling,red_latency"
SYNC_CSV_HEADER = "noise,P,s,measured,modeled,ceiling,red_latency"
FAULT_CSV_HEADER = ("kind,rate,P,onset,recovered,converged,overhead_iters,"
                    "bound_iters,overhead_ratio,n_shards_final")
SERVE_CSV_HEADER = "quantile,wall_s,sim_s,model_s,rel_err_model_vs_sim"
ABFT_CSV_HEADER = ("solver,detector,magnitude,threshold,onset,trip_iter,"
                   "detect_lag_iters,window_iters,modeled_iters,"
                   "boundary_iters,tripped,expect_trip,in_window,"
                   "false_positive")
PRECISION_CSV_HEADER = ("solver,policy,expect,true_res_rel,eps_storage,"
                        "floor_rel,res_over_eps,within_floor,precision_ok,"
                        "storage_words,wire_words,iters")
GEOMETRY_CSV_HEADER = ("format,grid,P,halo_elems,surface_to_volume,"
                       "msgs_modeled,strip_sends_expected,"
                       "strip_sends_per_iter,all_reduces_per_iter,"
                       "overlap_ok,t_iter_us,t_iter_noisy_us,accuracy_err")

REPORT_SECTIONS = (
    "## 1. Setup",
    "## 2. Measured vs modeled pipelined speedup",
    "## 3. Noise identification (Figs. 5/6 analogue)",
    "## 4. Noisy solver runs (Table 1 analogue)",
    "## 5. Residual drift (engine execution)",
    "## 6. Folk-theorem and crossover validation",
    "## 7. Depth-l pipelining sweep",
    "## 8. s-sync generalization (four-sync BiCGStab)",
    "## 9. Fault injection and elastic recovery",
    "## 10. Solver-as-a-service (queueing model vs measured)",
    "## 11. ABFT detection coverage (in-flight vs boundary)",
    "## 12. Mixed precision (Cools attainable-accuracy floors)",
    "## 13. Operator geometry (format x process-grid x noise sweep)",
)


def _jsonable(obj):
    """Recursively convert numpy containers/scalars for ``json.dump``;
    dict keys starting with ``_`` (the serve record's drained servers)
    are dropped."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()
                if not str(k).startswith("_")}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_jsonable(v) for v in obj.tolist()]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def write_speedup_csv(out_dir: Path, cells: Sequence[Dict]) -> Path:
    """Write the measured-vs-modeled speedup grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_speedup.csv"
    with open(path, "w") as f:
        f.write(SPEEDUP_CSV_HEADER + "\n")
        for c in cells:
            f.write(f"{c['noise']},{c['P']},{c['solver']},"
                    f"{c['measured_speedup']:.6f},{c['modeled_speedup']:.6f},"
                    f"{c['rel_err']:.6f},{c['hw_measured_speedup']:.6f},"
                    f"{c['hw_modeled_speedup']:.6f}\n")
    return path


def write_ecdf_csv(out_dir: Path, noise: str, samples,
                   stem: str = None) -> Path:
    """Write ECDF + fitted-CDF columns for one sample set (Fig 5/6 form).

    ``stem`` overrides the default ``campaign_ecdf_<noise>`` file stem.
    """
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    safe = stem or "campaign_ecdf_" + noise.replace(":", "_").lower()
    path = fig_dir / f"{safe}.csv"
    x, F, fits = ecdf_with_fits(samples)
    x, F = x.numpy(), F.numpy()
    fits = {k: v.numpy() for k, v in fits.items()}
    # header derived from the actual fit columns; ECDF_CSV_HEADER is the
    # schema contract tests pin — a FITTERS change fails loudly there
    # instead of silently mislabeling columns
    with open(path, "w") as f:
        f.write("x,ecdf," + ",".join(fits) + "\n")
        for i in range(len(x)):
            f.write(f"{x[i]:.6f},{F[i]:.6f},"
                    + ",".join(f"{fits[k][i]:.6f}" for k in fits) + "\n")
    return path


def write_depth_csv(out_dir: Path, depth_cells: Sequence[Dict]) -> Path:
    """Write the depth-l sweep grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_depth.csv"
    with open(path, "w") as f:
        f.write(DEPTH_CSV_HEADER + "\n")
        for c in depth_cells:
            f.write(f"{c['noise']},{c['P']},{c['l']},"
                    f"{c['measured_speedup']:.6f},{c['modeled_speedup']:.6f},"
                    f"{c['ceiling_speedup']:.6f},{c['red_latency']:.6f}\n")
    return path


def write_sync_csv(out_dir: Path, sync_cells: Sequence[Dict]) -> Path:
    """Write the s-sync sweep grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_sync.csv"
    with open(path, "w") as f:
        f.write(SYNC_CSV_HEADER + "\n")
        for c in sync_cells:
            f.write(f"{c['noise']},{c['P']},{c['s']},"
                    f"{c['measured_speedup']:.6f},{c['modeled_speedup']:.6f},"
                    f"{c['ceiling_speedup']:.6f},{c['red_latency']:.6f}\n")
    return path


def write_fault_csv(out_dir: Path, fault_cells: Sequence[Dict]) -> Path:
    """Write the fault-stage recovery-overhead grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_fault.csv"
    with open(path, "w") as f:
        f.write(FAULT_CSV_HEADER + "\n")
        for c in fault_cells:
            if c.get("skipped"):
                continue
            f.write(f"{c['kind']},{c['rate']},{c['n_shards']},"
                    f"{c['onset_iter']},{int(c['recovered'])},"
                    f"{int(c['converged'])},{c['overhead_iters']:.1f},"
                    f"{c['bound_iters']:.1f},{c['overhead_ratio']:.4f},"
                    f"{c['n_shards_final']}\n")
    return path


def write_serve_csv(out_dir: Path, serve: Dict) -> Path:
    """Write the serve-stage latency-quantile grid CSV; returns the path.

    One row per quantile: real wall-clock paced serve, deterministic
    batch-queue replay, and the analytic M/G/k model (rel err is model
    vs replay — the gated pair; both are deterministic).
    """
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_serve.csv"
    paced = serve["paced"]
    with open(path, "w") as f:
        f.write(SERVE_CSV_HEADER + "\n")
        for q in ("p50", "p99", "p999"):
            f.write(f"{q},{paced['wall']['latency'][q]:.6f},"
                    f"{paced['sim'][q]:.6f},{paced['predicted'][q]:.6f},"
                    f"{paced['rel_err'][q]:.6f}\n")
    return path


def write_abft_csv(out_dir: Path, abft_cells: Sequence[Dict]) -> Path:
    """Write the ABFT detection-coverage grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_abft.csv"
    with open(path, "w") as f:
        f.write(ABFT_CSV_HEADER + "\n")
        for c in abft_cells:
            if c.get("skipped"):
                continue
            f.write(f"{c['solver']},{c['detector']},{c['magnitude']:g},"
                    f"{c['threshold']:.3e},{c['onset_iter']},"
                    f"{c['trip_iter']},{c['detect_lag_iters']},"
                    f"{c['window_iters']},{c['modeled_detect_iters']:.1f},"
                    f"{c['boundary_detect_iters']:.1f},{int(c['tripped'])},"
                    f"{int(c['expect_trip'])},"
                    f"{int(c['detected_in_window'])},"
                    f"{int(c['false_positive'])}\n")
    return path


def write_precision_csv(out_dir: Path,
                        precision_cells: Sequence[Dict]) -> Path:
    """Write the precision-stage accuracy-floor grid CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_precision.csv"
    with open(path, "w") as f:
        f.write(PRECISION_CSV_HEADER + "\n")
        for c in precision_cells:
            if c.get("skipped"):
                continue
            f.write(f"{c['solver']},{c['policy']},{c['expect']},"
                    f"{c['true_res_rel']:.6e},{c['eps_storage']:.3e},"
                    f"{c['floor_rel']:.3e},{c['res_over_eps']:.4f},"
                    f"{int(c['within_floor'])},{int(c['precision_ok'])},"
                    f"{c['storage_words']:g},"
                    f"{c['wire_words']:g},{c['iters']}\n")
    return path


def write_geometry_csv(out_dir: Path,
                       geometry_cells: Sequence[Dict]) -> Path:
    """Write the geometry-stage format x grid sweep CSV; returns the path."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_geometry.csv"
    with open(path, "w") as f:
        f.write(GEOMETRY_CSV_HEADER + "\n")
        for c in geometry_cells:
            if c.get("skipped"):
                continue
            grid = "x".join(str(g) for g in c["grid"])
            f.write(f"{c['format']},{grid},{c['P']},{c['halo_elems']},"
                    f"{c['surface_to_volume']:.6f},{c['msgs_modeled']},"
                    f"{c['strip_sends_expected']},"
                    f"{c['strip_sends_per_iter']:g},"
                    f"{c['all_reduces_per_iter']:g},{int(c['overlap_ok'])},"
                    f"{c['t_iter_us']:.1f},{c['t_iter_noisy_us']:.1f},"
                    f"{c['accuracy_err']:.3e}\n")
    return path


def write_runtimes_csv(out_dir: Path, noisy_exec: Dict[str, Dict]) -> Path:
    """Write the noisy many-rank run-time samples per solver."""
    fig_dir = Path(out_dir) / "figures"
    fig_dir.mkdir(parents=True, exist_ok=True)
    path = fig_dir / "campaign_runtimes.csv"
    with open(path, "w") as f:
        f.write(RUNTIME_CSV_HEADER + "\n")
        for solver, cell in noisy_exec.items():
            for i, t in enumerate(np.asarray(cell["run_times"])):
                f.write(f"{solver},{i},{t:.6f}\n")
    return path


def write_json(path: Path, result: Dict) -> Path:
    """Dump the full campaign record as JSON at ``path``."""
    path = Path(path)
    with open(path, "w") as f:
        json.dump(_jsonable(result), f, indent=1, sort_keys=True)
    return path


def _fmt(v: float, nd: int = 4) -> str:
    return f"{v:.{nd}f}"


def write_report_md(out_dir: Path, result: Dict) -> Path:
    """Render the self-contained measured-vs-modeled REPORT.md."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = result["spec"]
    lines: List[str] = []
    w = lines.append
    w(f"# Campaign report — preset `{spec['name']}`")
    w("")
    w("Noise-injected Monte-Carlo solver experiments: measured pipelined")
    w("speedups vs the stochastic performance model (see DESIGN.md")
    w("§Campaign-methodology; regenerate with "
      f"`python -m repro_torch.experiments.campaign --preset "
      f"{spec['name']}`).")
    w("")
    w(REPORT_SECTIONS[0])
    w("")
    w(f"- solvers: {', '.join(spec['solvers'])} (vs classical partners)")
    w(f"- engines: {', '.join(spec['engines'])}")
    w(f"- noises: {', '.join(spec['noises'])}")
    w(f"- shard counts P: {spec['shard_counts']}")
    w(f"- trials x iterations per cell: {spec['trials']} x {spec['iters']}")
    w(f"- seed: {spec['seed']}")
    w("")
    w(REPORT_SECTIONS[1])
    w("")
    w("`measured` is the Monte-Carlo mean(T)/mean(T') of Eqs. (6)/(7) under")
    w("iid per-step waits; `modeled` the asymptotic E[max_P]/mu (Eq. 8).")
    w("`hw_*` columns add the per-solver phase-model compute/reduction")
    w("bases (core/noise/simulator.py) in seconds.")
    w("")
    w("| noise | P | solver | measured | modeled | rel err | hw measured | hw modeled |")
    w("|---|---:|---|---:|---:|---:|---:|---:|")
    for c in result["cells"]:
        w(f"| {c['noise']} | {c['P']} | {c['solver']} | "
          f"{_fmt(c['measured_speedup'])} | {_fmt(c['modeled_speedup'])} | "
          f"{_fmt(c['rel_err'])} | {_fmt(c['hw_measured_speedup'])} | "
          f"{_fmt(c['hw_modeled_speedup'])} |")
    w("")
    w(REPORT_SECTIONS[2])
    w("")
    w("Goodness-of-fit on the recorded per-(iteration, process) wait")
    w("samples: Cramer-von Mises for uniform / shifted exponential,")
    w("Lilliefors for log-normality (alpha = 0.05).  `match` compares the")
    w("classified best family against the injected one.")
    w("")
    w("| noise | injected | best fit | match | uniform T (crit) | exponential T (crit) | lognormal T (crit) |")
    w("|---|---|---|---|---|---|---|")
    for noise, fit in result["wait_fits"].items():
        s = fit["statistics"]
        match = ("n/a" if fit["family_match"] is None
                 else ("yes" if fit["family_match"] else "NO"))
        inj = fit["injected_family"] or "(trace)"
        w(f"| {noise} | {inj} | {fit['best_family']} | {match} | "
          f"{_fmt(s['uniform']['T'])} ({_fmt(s['uniform']['crit'], 3)}) | "
          f"{_fmt(s['exponential']['T'])} ({_fmt(s['exponential']['crit'], 3)}) | "
          f"{_fmt(s['lognormal']['T'])} ({_fmt(s['lognormal']['crit'], 3)}) |")
    w("")
    w("Fitted vs injected parameters (closed-form families):")
    w("")
    w("| noise | family | injected | fitted |")
    w("|---|---|---|---|")
    for noise, fit in result["wait_fits"].items():
        inj = fit.get("injected_params")
        if not inj:
            continue
        fam = fit["injected_family"]
        got = fit["params"][fam]
        w(f"| {noise} | {fam} | "
          + " ".join(f"{k}={_fmt(v)}" for k, v in inj.items()) + " | "
          + " ".join(f"{k}={_fmt(v)}" for k, v in got.items()) + " |")
    w("")
    w(REPORT_SECTIONS[3])
    w("")
    w("Real many-rank solves (`distributed_solve` + wall-clock NoiseHook,")
    w(f"noise `{spec['exec_noise']}` at {spec['noise_scale']} s/unit): run")
    w("times and summary statistics in the form of the paper's Table 1.")
    w("")
    w("| solver | n runs | mean (s) | median (s) | s | min | max | lambda |")
    w("|---|---:|---:|---:|---:|---:|---:|---:|")
    for solver, fit in result["runtime_fits"].items():
        s = fit["summary"]
        w(f"| {solver} | {s['n']} | {_fmt(s['mean'])} | {_fmt(s['median'])} | "
          f"{_fmt(s['s'])} | {_fmt(s['min'])} | {_fmt(s['max'])} | "
          f"{_fmt(s['lambda'])} |")
    w("")
    w(REPORT_SECTIONS[4])
    w("")
    w("Per-iteration wall time and Cools-style true-residual drift")
    w("(|true - recurrence| / ||b||) per iteration engine.")
    w("")
    w("| solver | engine | per-iter (us) | recurrence res | true res | drift |")
    w("|---|---|---:|---:|---:|---:|")
    for c in result["engine_exec"]:
        w(f"| {c['solver']} | {c['engine']} | {_fmt(c['per_iter_us'], 1)} | "
          f"{c['res_recurrence']:.3e} | {c['res_true']:.3e} | "
          f"{c['drift_rel']:.3e} |")
    w("")
    w(REPORT_SECTIONS[5])
    w("")
    v = result["validation"]
    for noise, row in v["per_noise"].items():
        w(f"- `{noise}`: measured crossover P(speedup>2x) = "
          f"{row['measured_crossover_P']}, modeled = "
          f"{row['modeled_crossover_P']}; max |measured-modeled|/modeled = "
          f"{_fmt(row['max_rel_err'])}")
    w("")
    w(REPORT_SECTIONS[6])
    w("")
    w("Lag-l synchronization makespans (reduction latency "
      f"R = {spec['depth_red_latency']} wait-means on the synchronized")
    w("critical path) vs the block-resync model; `ceiling` is the")
    w("l -> inf Eq. 8 asymptote.  `crossover l` is the smallest swept")
    w("depth reaching 65% of the ceiling (-1 = still latency-bound at")
    w("the deepest swept l).")
    w("")
    w("| noise | P | l | measured | modeled | ceiling |")
    w("|---|---:|---:|---:|---:|---:|")
    for c in result["depth_cells"]:
        w(f"| {c['noise']} | {c['P']} | {c['l']} | "
          f"{_fmt(c['measured_speedup'])} | {_fmt(c['modeled_speedup'])} | "
          f"{_fmt(c['ceiling_speedup'])} |")
    w("")
    for key, row in v.get("depth", {}).items():
        w(f"- `{key}`: crossover l measured = {row['crossover_l_measured']}, "
          f"modeled = {row['crossover_l_modeled']} "
          f"(ceiling {_fmt(row['ceiling_speedup'])})")
    w("")
    if result.get("depth_exec"):
        w("Real depth-l solves (`pipecg_l`, ghost-basis blocks): the")
        w("accuracy cost of pushing the pipeline deeper.")
        w("")
        w("| l | engine | per-iter (us) | recurrence res | true res | drift |")
        w("|---:|---|---:|---:|---:|---:|")
        for c in result["depth_exec"]:
            w(f"| {c['l']} | {c['engine']} | {_fmt(c['per_iter_us'], 1)} | "
              f"{c['res_recurrence']:.3e} | {c['res_true']:.3e} | "
              f"{c['drift_rel']:.3e} |")
        w("")
    w(REPORT_SECTIONS[7])
    w("")
    w("Classical CG exposes 2 synchronizations per iteration, classical")
    w("BiCGStab 4 — each both serializes a reduction latency")
    w(f"(R = {spec.get('sync_red_latency', 2.0)} wait-means here) and")
    w("re-exposes a max over processes; the pipelined partners fuse them")
    w("into ONE overlapped reduction (p-BiCGStab's single Gram psum).")
    w("`ceiling` is the latency-dominated limit s of the s-sync model")
    w("(core/perfmodel/sync.py): 2x for the CG family is the folk")
    w("theorem, 4x for the BiCGStab family strictly exceeds it.")
    w("")
    w("| noise | P | s | measured | modeled | ceiling |")
    w("|---|---:|---:|---:|---:|---:|")
    for c in result.get("sync_cells", []):
        w(f"| {c['noise']} | {c['P']} | {c['s']} | "
          f"{_fmt(c['measured_speedup'])} | {_fmt(c['modeled_speedup'])} | "
          f"{_fmt(c['ceiling_speedup'])} |")
    w("")
    for key, row in v.get("s_sync", {}).items():
        if key == "predict_speedup_latency_regime":
            continue
        w(f"- `{key}`: four-sync measured > 2x = "
          f"{row['four_sync_measured_gt_2x']}, modeled > 2x = "
          f"{row['four_sync_modeled_gt_2x']} "
          f"(max rel err {_fmt(row['max_rel_err'])})")
    pred = v.get("s_sync", {}).get("predict_speedup_latency_regime")
    if pred:
        w(f"- `predict_speedup` (phase model, P={pred['P']}, latency "
          f"regime): four-sync {_fmt(pred['bicgstab'])}x vs two-sync "
          f"{_fmt(pred['cg'])}x")
    w("")
    w(REPORT_SECTIONS[8])
    w("")
    w("One fault per cell injected into a REAL many-rank sharded")
    w("solve (spawned ranks); the elastic")
    w("controller (`distributed/fault.py`) detects it at a segment")
    w("boundary, recovers — rollback + residual-replacement restart on a")
    w("survivor group for kill/corrupt, eviction + exact carried-state")
    w("continuation for stall — and converges to the clean accuracy.")
    w("`overhead` is iteration-denominated (re-executed iterations for")
    w("kill/corrupt, detection latency for stall); `bound` is the")
    w("`core/perfmodel/resync.py` lower bound for the checkpoint period")
    w(f"({spec.get('fault_checkpoint_period', 10)} iterations here);")
    w("acceptance requires `ratio <= 2`.")
    w("")
    w("| kind | rate | P | onset | recovered | converged | overhead (it) "
      "| bound (it) | ratio | shards left |")
    w("|---|---:|---:|---:|---|---|---:|---:|---:|---:|")
    for c in result.get("fault_cells", []):
        if c.get("skipped"):
            continue
        w(f"| {c['kind']} | {c['rate']} | {c['n_shards']} | "
          f"{c['onset_iter']} | {'yes' if c['recovered'] else 'NO'} | "
          f"{'yes' if c['converged'] else 'NO'} | "
          f"{c['overhead_iters']:.0f} | {c['bound_iters']:.1f} | "
          f"{_fmt(c['overhead_ratio'], 2)} | {c['n_shards_final']} |")
    w("")
    for key, row in v.get("fault", {}).items():
        w(f"- `{key}`: recovered = {row['recovered']}, overhead "
          f"{row['overhead_iters']:.0f} it vs bound "
          f"{row['bound_iters']:.1f} it (ratio "
          f"{_fmt(row['overhead_ratio'], 2)}, within 2x = "
          f"{row['within_bound_factor']})")
    w("")
    w(REPORT_SECTIONS[9])
    w("")
    serve = result.get("serve") or {}
    if serve:
        burst, paced = serve["burst"], serve["paced"]
        b, s = burst["batched"], burst["sequential"]
        w(f"Open-loop burst of {burst['n_requests']} solves "
          f"(n = {burst['n']}, tol-frozen multi-RHS batch of "
          f"{burst['k_slots']} slots, `{burst['engine']}` engine, warm")
        w("executables) vs the same requests served one at a time;")
        w("latencies in seconds.")
        w("")
        w("| mode | throughput (req/s) | occupancy | p50 | p99 | p999 |")
        w("|---|---:|---:|---:|---:|---:|")
        w(f"| batched (k={burst['k_slots']}) | "
          f"{_fmt(b['throughput_rps'], 1)} | "
          f"{_fmt(b['occupancy_mean'], 2)} | {_fmt(b['latency']['p50'])} | "
          f"{_fmt(b['latency']['p99'])} | {_fmt(b['latency']['p999'])} |")
        w(f"| sequential (k=1) | {_fmt(s['throughput_rps'], 1)} | "
          f"{_fmt(s['occupancy_mean'], 2)} | {_fmt(s['latency']['p50'])} | "
          f"{_fmt(s['latency']['p99'])} | {_fmt(s['latency']['p999'])} |")
        w("")
        w(f"Throughput speedup: **{_fmt(burst['throughput_speedup'], 2)}x**"
          " (acceptance floor 2x).")
        w("")
        w(f"Paced run at rho = {paced['rho']} "
          f"(`{paced['arrival']}` arrivals, lambda = "
          f"{_fmt(paced['lam'], 1)} req/s): sojourn quantiles of the real")
        w("wall-clock serve, the deterministic batch-queue replay, and")
        w("the analytic Eq. 6/7 x M/G/k model (`core/perfmodel/")
        w("queueing.py`); the gate compares model vs replay.")
        w("")
        w("| quantile | wall (s) | replay (s) | model (s) | rel err |")
        w("|---|---:|---:|---:|---:|")
        for q in ("p50", "p99", "p999"):
            w(f"| {q} | {_fmt(paced['wall']['latency'][q])} | "
              f"{_fmt(paced['sim'][q])} | {_fmt(paced['predicted'][q])} | "
              f"{_fmt(paced['rel_err'][q])} |")
        w("")
        sv = v.get("serve", {})
        if sv:
            w(f"- accuracy: max |batched - solo| = "
              f"{sv['accuracy_max_abs_diff']:.2e} over the sampled "
              f"retirements (ok = {sv['accuracy_ok']})")
            w(f"- drained = {sv['drained']}, all converged = "
              f"{sv['all_converged']}")
            w("")
    else:
        w("(serve stage disabled: `serve_requests = 0`)")
        w("")
    w(REPORT_SECTIONS[10])
    w("")
    abft_cells = [c for c in result.get("abft_cells", [])
                  if not c.get("skipped")]
    if abft_cells:
        w("One silent `corrupt` fault per cell injected into a REAL")
        w("sharded solve; the carried ABFT detector (checksum row for the")
        w("depth-1 bodies, state deviation for the depth-l blocks) must")
        w("trip within the modeled window when the magnitude exceeds the")
        w("rounding-floor threshold, and never trip on the clean twin.")
        w("`boundary` is the segment-boundary detection latency")
        w("`(period + 1) / 2` — the iterations the in-flight detector")
        w("buys back.")
        w("")
        w("| solver | detector | magnitude | onset | trip | lag (it) "
          "| window | boundary (it) | fp |")
        w("|---|---|---:|---:|---:|---:|---:|---:|---|")
        for c in abft_cells:
            w(f"| {c['solver']} | {c['detector']} | {c['magnitude']:g} | "
              f"{c['onset_iter']} | {c['trip_iter']} | "
              f"{c['detect_lag_iters']} | {c['window_iters']} | "
              f"{c['boundary_detect_iters']:.1f} | "
              f"{'YES' if c['false_positive'] else 'no'} |")
        w("")
        for key, row in v.get("abft", {}).items():
            extra = ""
            if "recovery_ok" in row:
                extra = (f", recovery via fast path = {row['recovery_ok']}"
                         f" ({row['recovery_detect_iters']:.0f} it)")
            w(f"- `{key}`: expect trip = {row['expect_trip']}, tripped = "
              f"{row['tripped']}, in window = "
              f"{row['detection_ok']}{extra}")
        w("")
    else:
        w("(abft stage disabled: `abft_solvers = ()`)")
        w("")
    w(REPORT_SECTIONS[11])
    w("")
    prec_cells = [c for c in result.get("precision_cells", [])
                  if not c.get("skipped")]
    if prec_cells:
        w("Each cell runs a REAL sharded solve to its accuracy plateau")
        w("under a `PrecisionPolicy` and measures the TRUE residual")
        w("`|b - A x|/|b|` (the carried recurrence residual underflows")
        w("past the storage floor).  `floor` is the Cools-style")
        w("attainable-accuracy bound `C_solver * eps_storage` (the")
        w("solver's measured rounding amplification: ~1.2x for p-CG,")
        w("~10-19x for p-BiCGStab's two-SpMV recurrence).  SAFE policies")
        w("(fp32, bf16 storage, bf16 + int8 halo wire with error")
        w("feedback) must land within it; the DEGRADED demonstrator")
        w("(int8 wire without error feedback) stays within the floor but")
        w("measurably above its EF partner; the UNSAFE demonstrator")
        w("(int8 on the carried Gram psum) lands orders outside it.")
        w("")
        w("| solver | policy | expect | true res | floor | res/eps "
          "| within | ok | words (store/wire) |")
        w("|---|---|---|---:|---:|---:|---|---|---:|")
        for c in prec_cells:
            w(f"| {c['solver']} | {c['policy']} | {c['expect']} | "
              f"{c['true_res_rel']:.2e} | {c['floor_rel']:.2e} | "
              f"{_fmt(c['res_over_eps'], 2)} | "
              f"{'yes' if c['within_floor'] else 'NO'} | "
              f"{'yes' if c['precision_ok'] else 'NO'} | "
              f"{c['storage_words']:g}/{c['wire_words']:g} |")
        w("")
        pv = v.get("precision", {})
        nef = pv.get("noef_vs_ef")
        if nef:
            w(f"- int8 wire without error feedback degrades the plateau "
              f"{_fmt(nef['ratio'], 2)}x over the EF variant "
              f"(>= {nef['factor']}x required: {nef['degrades']})")
        order = pv.get("split_phase")
        if order:
            w(f"- split-phase overlap with compressed wire: "
              f"{order['overlap_ok']}")
        conv = pv.get("regime_conversion")
        if conv:
            w(f"- modeled regime conversion (`predict_speedup`, "
              f"bandwidth-bound point): fp32 "
              f"{_fmt(conv['fp32_speedup'], 2)}x -> bf16 "
              f"{_fmt(conv['bf16_speedup'], 2)}x, latency-bound = "
              f"{conv['bf16_latency_bound']}")
        w("")
    else:
        w("(precision stage disabled: `precision_policies = ()`)")
        w("")
    w(REPORT_SECTIONS[12])
    w("")
    geo_cells = [c for c in result.get("geometry_cells", [])
                 if not c.get("skipped")]
    if geo_cells:
        w("Each cell runs a REAL many-rank `sharded_fused` solve for")
        w("one operator format x process-grid point and is gated against")
        w("the surface-to-volume communication model")
        w("(`core/perfmodel/comm.py`): every rank must issue exactly ONE")
        w("all-reduce per iteration in the split-phase order (the order")
        w("recorder, `distributed/overlap.py`), and the strips the group")
        w("sends per iteration, by vector and face, must equal `2 vectors")
        w("x 2 messages per decomposed axis`; the sharded")
        w("solution must match the single-device reference.  `noisy` adds")
        w("a wall-clock per-iteration stall (the noise axis).")
        w("")
        w("| format | grid | P | halo elems | S/V | msgs (model) "
          "| strip sends (measured/model) | all-reduce | t/iter (us) "
          "| noisy (us) | err |")
        w("|---|---|---:|---:|---:|---:|---:|---:|---:|---:|---:|")
        for c in geo_cells:
            grid = "x".join(str(g) for g in c["grid"])
            w(f"| {c['format']} | {grid} | {c['P']} | {c['halo_elems']} | "
              f"{_fmt(c['surface_to_volume'])} | {c['msgs_modeled']} | "
              f"{c['strip_sends_per_iter']:g}/"
              f"{c['strip_sends_expected']} | "
              f"{c['all_reduces_per_iter']:g} | "
              f"{_fmt(c['t_iter_us'], 1)} | "
              f"{_fmt(c['t_iter_noisy_us'], 1)} | "
              f"{c['accuracy_err']:.2e} |")
        w("")
        gv = v.get("geometry", {})
        for key, row in gv.items():
            if key == "best_grid":
                continue
            w(f"- `{key}`: accuracy ok = {row['accuracy_ok']}, one "
              f"all-reduce = {row['one_all_reduce']}, overlap = "
              f"{row['overlap_ok']}, msgs match = "
              f"{row['strip_msgs_match']}, noise slowdown = "
              f"{_fmt(row['noise_slowdown'], 2)}x")
        bg = gv.get("best_grid")
        if bg:
            w(f"- `best_grid`: comm model picks "
              f"{tuple(bg['modeled'])}; swept minimum "
              f"{tuple(bg['swept_min_elems'])} (matches = "
              f"{bg['matches_comm_model']})")
        w("")
    else:
        w("(geometry stage disabled: `geometry_formats = ()`)")
        w("")
    for check, ok in v["acceptance"].items():
        w(f"- {'PASS' if ok else 'FAIL'}: {check}")
    w("")
    path = out_dir / "REPORT.md"
    path.write_text("\n".join(lines))
    return path
