"""Campaign validation stage: measured speedups against the §3 model (the
JAX package's ``experiments/validation.py``).

Checks, per noise distribution:
  * measured mean(T)/mean(T') vs ``asymptotic_speedup`` (E[max_P]/mu);
  * the deterministic folk-theorem 2x bound — uniform noise must stay
    below it at every P (closed form 2P/(P+1) < 2), exponential must
    cross it at P = 4 (H_4 = 25/12 > 2, the paper's headline);
  * the measured crossover P vs ``min_procs_exceeding``.

The JAX package proves the geometry and precision stages' split-phase
overlap from compiled HLO; the port has none (ROADMAP.md H5), so those
validators read the stages' order-recorder fields instead
(``distributed/overlap.py``): all-reduces per iteration, ``overlap_ok``
as ``split_phase_ok`` on every rank, and the strip sends per iteration
by vector and face.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.perfmodel import asymptotic_speedup, min_procs_exceeding
from repro_torch.core.perfmodel.distributions import Distribution


def modeled_speedup(dist: Distribution, P: int, device="cuda") -> float:
    """Asymptotic model prediction E[max of P draws] / mean (paper Eq. 8);
    ``device`` evaluates a quadrature where there is no closed form."""
    return asymptotic_speedup(dist, P, method="auto", device=device)


def measured_crossover(cells: Sequence[Dict], noise: str,
                       bound: float = 2.0) -> int:
    """Smallest P whose MEASURED speedup exceeds ``bound`` (-1 if none)."""
    ps = sorted(c["P"] for c in cells
                if c["noise"] == noise and c["measured_speedup"] > bound)
    return ps[0] if ps else -1


def validate_depth_cells(depth_cells: Sequence[Dict],
                         frac: float = 0.65) -> Dict:
    """Depth-sweep validation: crossover depths + monotonicity.

    For every (noise, P) of the depth grid: the measured and modeled
    crossover depth (smallest swept l whose speedup reaches
    ``frac * ceiling``, the l -> inf Eq. 8 asymptote), whether the
    measured speedup is monotone non-decreasing in l, and whether the
    block-resync model stays a lower bound on the measured lag-l
    speedup (5% slack for Monte-Carlo noise).
    """
    from repro_torch.core.perfmodel import crossover_depth

    out: Dict = {}
    keys = sorted({(c["noise"], c["P"]) for c in depth_cells})
    for noise, P in keys:
        mine = sorted((c for c in depth_cells
                       if c["noise"] == noise and c["P"] == P),
                      key=lambda c: c["l"])
        measured = {c["l"]: c["measured_speedup"] for c in mine}
        modeled = {c["l"]: c["modeled_speedup"] for c in mine}
        ceiling = mine[0]["ceiling_speedup"]
        seq = [measured[l] for l in sorted(measured)]
        out[f"{noise}/P{P}"] = {
            "crossover_l_measured": crossover_depth(measured, ceiling,
                                                    frac=frac),
            "crossover_l_modeled": crossover_depth(modeled, ceiling,
                                                   frac=frac),
            "ceiling_speedup": ceiling,
            "measured_monotone": all(b >= a * 0.98
                                     for a, b in zip(seq, seq[1:])),
            "model_is_lower_bound": all(
                c["modeled_speedup"] <= c["measured_speedup"] * 1.05
                for c in mine),
        }
    return out


def validate_s_sync_cells(sync_cells: Sequence[Dict]) -> Dict:
    """s-sync sweep validation: the four-sync ceiling beyond the folk 2x.

    For every (noise, P) of the sync grid: whether the measured speedup
    is monotone non-decreasing in the sync count s (more serialized
    reductions -> more to hide), whether the four-sync cell exceeds the
    folk-theorem 2x both measured and modeled, and the worst
    measured-vs-modeled relative error.
    """
    out: Dict = {}
    keys = sorted({(c["noise"], c["P"]) for c in sync_cells})
    for noise, P in keys:
        mine = sorted((c for c in sync_cells
                       if c["noise"] == noise and c["P"] == P),
                      key=lambda c: c["s"])
        seq = [c["measured_speedup"] for c in mine]
        four = [c for c in mine if c["s"] == 4]
        rel_errs = [abs(c["measured_speedup"] - c["modeled_speedup"])
                    / c["modeled_speedup"] for c in mine]
        out[f"{noise}/P{P}"] = {
            "measured_monotone_in_s": all(b >= a * 0.98
                                          for a, b in zip(seq, seq[1:])),
            "four_sync_measured_gt_2x": bool(four) and all(
                c["measured_speedup"] > 2.0 for c in four),
            "four_sync_modeled_gt_2x": bool(four) and all(
                c["modeled_speedup"] > 2.0 for c in four),
            "max_rel_err": max(rel_errs),
        }
    return out


def validate_fault_cells(fault_cells: Sequence[Dict],
                         overhead_factor: float = 2.0) -> Dict:
    """Fault-stage validation: recovery vs the resync overhead bound.

    For every executed fault cell (kind, rate, P): whether the injected
    fault was detected AND recovered from, whether the elastic solve
    still converged, whether its true residual stayed within 100x of the
    clean baseline's (the rr re-glue restores accuracy; the slack covers
    the stall path, which converges at the clean trajectory exactly),
    and whether the measured iteration overhead stays within
    ``overhead_factor`` of the ``recovery_overhead_bound`` floor.
    """
    out: Dict = {}
    for c in fault_cells:
        if c.get("skipped"):
            continue
        key = f"{c['kind']}/rate{c['rate']}/P{c['n_shards']}"
        accuracy_ok = (c["true_res"]
                       <= max(c["clean_true_res"] * 100.0, 1e-9))
        out[key] = {
            "recovered": bool(c["recovered"]),
            "converged": bool(c["converged"]),
            "accuracy_ok": bool(accuracy_ok),
            "overhead_iters": float(c["overhead_iters"]),
            "bound_iters": float(c["bound_iters"]),
            "overhead_ratio": float(c["overhead_ratio"]),
            "within_bound_factor": (c["overhead_ratio"]
                                    <= overhead_factor + 1e-12),
            "n_shards_final": int(c["n_shards_final"]),
        }
    return out


def validate_serve_cells(serve: Dict, tolerance: float = 0.10) -> Dict:
    """Serve-stage validation: throughput, accuracy and the M/G/k model.

    ``serve`` is the record of ``serve_exec.run_serve_exec`` (empty dict
    = stage disabled, returns ``{}``).  Checks the serve acceptance
    surface: batched-vs-sequential throughput >= 2x, the queueing
    perfmodel's predicted p50/p99 within ``tolerance`` (the same 10% the
    speedup cells use) of the deterministic batch-queue replay, p999
    recorded (finite-run tail atoms are coarser), mid-flight-retired
    solutions matching solo serves to 1e-10, and both serve runs
    draining with every request converged.
    """
    if not serve:
        return {}
    burst, paced = serve["burst"], serve["paced"]
    b = burst["batched"]
    rel = paced["rel_err"]
    return {
        "throughput_speedup": float(burst["throughput_speedup"]),
        "throughput_ge_2x": bool(burst["throughput_speedup"] >= 2.0),
        "occupancy_mean": float(b["occupancy_mean"]),
        "p50_rel_err": float(rel["p50"]),
        "p99_rel_err": float(rel["p99"]),
        "p999_rel_err": float(rel["p999"]),
        "model_within_tolerance": bool(rel["p50"] <= tolerance
                                       and rel["p99"] <= tolerance),
        "tolerance": tolerance,
        "accuracy_max_abs_diff": max(
            (c["max_abs_diff"] for c in serve["accuracy"]), default=0.0),
        "accuracy_ok": all(c["match_1e10"] for c in serve["accuracy"]),
        "drained": bool(b["drained"] and paced["wall"]["drained"]),
        "all_converged": bool(
            b["n_converged"] == b["n_requests"]
            and paced["wall"]["n_converged"] == paced["wall"]["n_requests"]),
    }


def validate_cells(cells: Sequence[Dict],
                   dists: Dict[str, Distribution], device="cuda") -> Dict:
    """Cross-cell validation summary for the report.

    ``cells`` are discrete-event cell dicts with at least ``noise``,
    ``P``, ``measured_speedup`` and ``modeled_speedup`` keys; ``device``
    evaluates the model's quadratures.
    """
    out: Dict = {"per_noise": {}, "folk_2x": {}}
    for noise, dist in dists.items():
        mine = [c for c in cells if c["noise"] == noise]
        if not mine:
            continue
        rel_errs = [abs(c["measured_speedup"] - c["modeled_speedup"])
                    / c["modeled_speedup"] for c in mine]
        measured_x = measured_crossover(cells, noise)
        modeled_x = min_procs_exceeding(dist, bound=2.0, pmax=1 << 14,
                                        device=device)
        out["per_noise"][noise] = {
            "max_rel_err": max(rel_errs),
            "mean_rel_err": sum(rel_errs) / len(rel_errs),
            "measured_crossover_P": measured_x,
            "modeled_crossover_P": modeled_x,
            "ever_exceeds_2x_measured": measured_x != -1,
        }
        out["folk_2x"][noise] = {
            "max_measured": max(c["measured_speedup"] for c in mine),
            "max_modeled": max(c["modeled_speedup"] for c in mine),
        }
    return out


def validate_precision_cells(precision: Dict,
                             noef_factor: float = 1.05) -> Dict:
    """Precision-stage validation: Cools floors + wire-compression safety.

    ``precision`` is the record of ``precision_exec.run_precision_exec``
    (empty dict = stage disabled, returns ``{}``).  Per (solver, policy)
    cell ``precision_ok`` carries the worker's ``_classify`` verdict:
    the measured TRUE residual within the solver's amplified
    attainable-accuracy floor for safe cells, outside it for unsafe
    demonstrators, floor + no-EF/EF ratio for degraded ones.  Three
    cross-cell checks close the loop:

    * ``noef_vs_ef`` — int8 wire WITHOUT error feedback must degrade the
      pipecg plateau by at least ``noef_factor`` over the EF variant
      (the bias the feedback loop removes is measurable, not cosmetic;
      measured ratio 1.15 at 128-lane strips);
    * ``split_phase`` — the bf16+int8-wire solve keeps the split-phase
      order with one all-reduce per iteration on every rank (the order
      recorder's check; the JAX package reads it from HLO);
    * ``regime_conversion`` — ``predict_speedup(precision=...)`` at the
      bandwidth-bound operating point: bf16 storage must flip the
      pipelined step into the latency-bound regime and beat the fp32
      predicted speedup.
    """
    if not precision:
        return {}
    out: Dict = {}
    res: Dict[str, float] = {}
    for c in precision.get("cells", []):
        if c.get("skipped"):
            continue
        key = f"{c['solver']}/{c['policy']}"
        res[key] = c["true_res_rel"]
        out[key] = {
            "expect": c["expect"],
            "expect_safe": bool(c["expect_safe"]),
            "within_floor": bool(c["within_floor"]),
            "precision_ok": bool(c["precision_ok"]),
            "true_res_rel": float(c["true_res_rel"]),
            "floor_rel": float(c["floor_rel"]),
            "res_over_eps": float(c["res_over_eps"]),
        }
    ef = res.get("pipecg/bf16_int8wire")
    noef = res.get("pipecg/bf16_int8wire_noef")
    if ef and noef:
        out["noef_vs_ef"] = {
            "ratio": noef / ef,
            "factor": noef_factor,
            "degrades": bool(noef > ef * noef_factor),
        }
    order = precision.get("order_bf16_int8wire") or {}
    if order:
        out["split_phase"] = {"overlap_ok": bool(order.get("overlap_ok"))}
    model = precision.get("model", {})
    if "fp32" in model and "bf16" in model:
        out["regime_conversion"] = {
            "fp32_speedup": model["fp32"]["speedup"],
            "bf16_speedup": model["bf16"]["speedup"],
            "bf16_latency_bound": bool(model["bf16"]["pipe_latency_bound"]),
            "converted": bool(
                model["bf16"]["pipe_latency_bound"]
                and model["bf16"]["speedup"] > model["fp32"]["speedup"]),
        }
    return out


def validate_geometry_cells(geometry_cells: Sequence[Dict],
                            accuracy_tol: float = 1e-8) -> Dict:
    """Geometry-stage validation: measured collectives vs the comm model.

    For every executed (format, grid) cell: the sharded solution must
    match the single-device reference to ``accuracy_tol``, every rank
    must issue exactly ONE all-reduce per iteration in the split-phase
    order (``overlap.split_phase_ok`` on every rank), and the strips the
    group sends per iteration, counted by vector and face, must equal
    the surface-to-volume message model over the DECOMPOSED axes,
    ``n_halo_vecs * 2 * active_dims`` (``core/perfmodel/comm.py``; a
    size-1 grid axis has no neighbor).
    A cross-cell check confirms ``comm.best_grid`` names the swept 2-D
    grid with the fewest modeled halo elements.
    """
    from repro_torch.core.perfmodel import comm

    out: Dict = {}
    grids_2d: Dict[tuple, int] = {}
    for c in geometry_cells:
        if c.get("skipped"):
            continue
        key = f"{c['format']}/{'x'.join(str(g) for g in c['grid'])}"
        out[key] = {
            "P": int(c["P"]),
            "accuracy_err": float(c["accuracy_err"]),
            "accuracy_ok": bool(c["accuracy_err"] <= accuracy_tol),
            "one_all_reduce": bool(c["all_reduces_per_iter"] == 1),
            "overlap_ok": bool(c["overlap_ok"]),
            "strip_msgs_match": bool(
                c["strip_sends_per_iter"] == c["strip_sends_expected"]),
            "surface_to_volume": float(c["surface_to_volume"]),
            "halo_elems": int(c["halo_elems"]),
            "t_iter_us": float(c["t_iter_us"]),
            "noise_slowdown": float(c["t_iter_noisy_us"]
                                    / max(c["t_iter_us"], 1e-9)),
        }
        if c["format"] == "dia2d":
            grids_2d[tuple(c["grid"])] = int(c["halo_elems"])
    if grids_2d:
        c0 = next(c for c in geometry_cells
                  if c.get("format") == "dia2d" and not c.get("skipped"))
        points = tuple(int(e) * int(g) for e, g
                       in zip(c0["extents"], c0["grid"]))
        best = comm.best_grid(points, int(c0["P"]))
        swept_min = min(grids_2d, key=grids_2d.get)
        out["best_grid"] = {
            "modeled": list(best),
            "swept_min_elems": list(swept_min),
            "matches_comm_model": bool(
                best not in grids_2d
                or grids_2d[best] == grids_2d[swept_min]),
        }
    return out


def validate_abft_cells(abft_cells: Sequence[Dict]) -> Dict:
    """ABFT-stage validation: detection coverage of the carried detectors.

    For every executed (solver, magnitude) cell: a supra-threshold
    corruption must trip its carried detector within the modeled window
    (1 iteration for the depth-1 bodies, l for the block-granular depth
    path), a sub-threshold one must NOT trip (it is below the rounding
    floor), and the clean twin run must never trip (zero false
    positives).  pipecg cells additionally close the loop through the
    elastic controller: the recovery must be driven by the ``checksum``
    fast path and still converge.
    """
    out: Dict = {}
    for c in abft_cells:
        if c.get("skipped"):
            continue
        key = f"{c['solver']}/mag{c['magnitude']:g}"
        detection_ok = bool(
            (c["detected_in_window"] if c["expect_trip"]
             else not c["tripped"]))
        row = {
            "detector": c["detector"],
            "expect_trip": bool(c["expect_trip"]),
            "tripped": bool(c["tripped"]),
            "detect_lag_iters": float(c["detect_lag_iters"]),
            "window_iters": float(c["window_iters"]),
            "modeled_detect_iters": float(c["modeled_detect_iters"]),
            "boundary_detect_iters": float(c["boundary_detect_iters"]),
            "false_positive": bool(c["false_positive"]),
            "detection_ok": detection_ok,
        }
        if "recovered" in c:
            row["recovery_ok"] = bool(
                c["recovered"] and c["recovery_converged"]
                and c["recovery_detector"] == "checksum")
            row["recovery_detect_iters"] = float(c["recovery_detect_iters"])
        out[key] = row
    return out
