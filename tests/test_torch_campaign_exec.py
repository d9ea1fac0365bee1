"""The campaign's execution stages of the port against the JAX package,
on gloo CPU ranks.

One spawn of 4 ranks runs every many-rank cell of every stage
(``experiments/runner.py::run_rank_jobs``: the sharded engine cells, the
noisy repeats, the fault, ABFT, precision and geometry stages), as the
campaign does on the card; the one-device engine and depth cells run in
this process.  Beside it, ONE JAX subprocess (tests/jax_slice_reference.py:
4 forced host devices, x64, the Pallas halo and chain sweeps replaced by
the kernels' arithmetic in jnp, H1) runs the JAX package's runner on the
naive engine and each stage's ``_run_cells`` worker on the same
configuration: the smoke preset's stage sizes (fault and ABFT n = 240,
precision n = 1024, geometry 16 x 16) and ex23 at n = 2048 for the
execution cells.

Held:
- engine and depth cells: every engine's (naive, fused, sharded_fused on
  4 ranks) recurrence and true residuals to rtol 1e-10 of the
  reference's naive cells (16 / 40 iterations: inside the H6 window),
  their drifts to 1e-10 of ||b||;
- noisy cells: the same multiset of injected waits (each rank's
  ``(seed + 977 si, rank)`` substream; the order differs, so sorted) and
  the residuals to rtol 1e-10;
- fault: recovery events, onsets, iteration counts and overhead equal;
- ABFT: trips, lags, detections and false positives per cell equal, the
  thresholds to rtol 1e-10, the recovery's detector and latency equal;
- precision: the PIPECG cells' true residuals within 1e-4 of the
  reference's plateaus (plus 1e-6 of the storage eps for the fp32 cell,
  at float64 rounding) and their ``_classify``
  verdicts equal; the p-BiCGStab cells are H8's drift past convergence
  (H13), so they are held to finite plateaus below ||b||, bf16 above
  fp32, each within a factor of 10 of the reference's; run once more at
  12 iterations (inside the H6 window), each policy's true residual
  equals the reference's to rtol 1e-10 (plus 1e-6 of the storage eps);
  one all-reduce per
  iteration and the split-phase order on every rank for the
  bf16+int8-wire cell; ``model_cells`` bit for bit on the reference's
  hardware fields;
- geometry: ``_cell_geometry`` bit for bit (on the reference's hardware
  fields), ``accuracy_err`` at most 1e-9, one all-reduce an iteration,
  the split-phase order on every rank, and the strips sent per iteration
  by vector and face equal to the message model (the reference's
  ``ppermute_expected``).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses

import numpy as np
import pytest

import jax_slice_reference as R
from repro.core.noise.simulator import Hardware as JHardware
from repro.experiments import geometry_exec as jgeom
from repro.experiments import precision_exec as jprec
from repro.experiments.spec import CampaignSpec as JSpec
from repro_torch.convert import model_from_fields
from repro_torch.experiments import abft_exec, fault_exec, geometry_exec
from repro_torch.experiments import precision_exec, runner
from repro_torch.experiments.noise_sources import make_distribution
from repro_torch.experiments.spec import get_preset
from repro_torch.experiments.validation import (validate_abft_cells,
                                                validate_fault_cells,
                                                validate_geometry_cells,
                                                validate_precision_cells)

CPU = "cpu"
WORLD = 4
# 16 iterations: inside the H6 window of the BiCGStab family on ex23
# (the JAX and torch histories part past ~20 iterations at n = 2048)
EXEC = dict(n=2048, maxiter=16, repeats=1)
EXEC_SOLVERS = ("cg", "pipecg", "bicgstab", "pipebicgstab")
ENGINES = ("naive", "fused", "sharded_fused")
DEPTHS = (1, 2, 4)
DEPTH_ITERS = 40
NOISY = dict(noise="exponential", noise_scale=2e-4, n=2048, maxiter=16,
             repeats=2, seed=0)
SPEC = get_preset("smoke")
# the precision stage's p-BiCGStab cells once more at a budget of 8, which
# the stage runs as 12 iterations: inside the H6 window under every policy
# (tests/test_torch_wire.py), where the port must land on the reference
PRECISION_WINDOW = dict(
    n=SPEC.precision_n, maxiter=8, seed=SPEC.seed,
    cells=[c for c in precision_exec.stage_cells(SPEC)
           if c["solver"] == "pipebicgstab"])
JSPEC = JSpec(**{f.name: getattr(SPEC, f.name)
                 for f in dataclasses.fields(SPEC)})
HW = model_from_fields("Hardware", dataclasses.asdict(JHardware()))


def _reference_cfg(out):
    """The JAX package's stage configurations, built as its own parents
    build them from the same spec."""
    s = JSPEC
    return {
        "devices": WORLD, "out": out, "wire": [], "elastic": [],
        "campaign": {
            "engine": dict(solvers=EXEC_SOLVERS, engines=("naive",),
                           **EXEC),
            "depth": dict(depths=DEPTHS, n=EXEC["n"], maxiter=DEPTH_ITERS,
                          repeats=1, engines=("naive",)),
            "noisy": dict(solvers=EXEC_SOLVERS, **NOISY),
            "fault": {
                "n": s.fault_n, "maxiter": s.fault_maxiter,
                "checkpoint_period": s.fault_checkpoint_period,
                "tol": s.fault_tol, "stall_s": s.fault_stall_s,
                "seed": s.seed,
                "cells": [{"kind": k, "rate": r, "n_shards": p}
                          for k in s.fault_kinds for r in s.fault_rates
                          for p in s.fault_shard_counts]},
            "abft": {
                "n": s.abft_n, "shards": s.abft_shards,
                "maxiter": s.abft_maxiter, "tol": s.abft_tol,
                "depth": s.abft_depth,
                "checkpoint_period": s.fault_checkpoint_period,
                "seed": s.seed,
                "cells": [{"solver": v, "magnitude": m}
                          for v in s.abft_solvers
                          for m in s.abft_magnitudes]},
            "precision": {"n": s.precision_n, "shards": s.precision_shards,
                          "maxiter": s.precision_maxiter, "seed": s.seed,
                          "cells": jprec.stage_cells(s)},
            "precision_window": dict(
                PRECISION_WINDOW, shards=s.precision_shards,
                cells=[c for c in jprec.stage_cells(s)
                       if c["solver"] == "pipebicgstab"]),
            "geometry": {
                "points": list(s.geometry_points),
                "maxiter": s.geometry_maxiter, "tol": s.geometry_tol,
                "repeats": s.geometry_repeats, "bs": s.geometry_bs,
                "noise_scale": s.geometry_noise_scale, "seed": s.seed,
                "cells": [{"format": f, "grid": list(g)}
                          for f in s.geometry_formats
                          for g in (s.geometry_grids if f == "dia2d"
                                    else [(s.geometry_shards,)])]},
        },
    }


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """(port, reference): the port's stage records from one spawn of 4
    ranks (run while the JAX subprocess computes the reference's)."""
    out = str(tmp_path_factory.mktemp("campaign_ref") / "ref.pkl")
    proc = R.start(_reference_cfg(out))
    try:
        dist = make_distribution(NOISY["noise"], device=CPU)
        jobs = {
            "abft": abft_exec.abft_jobs(SPEC),
            "precision": precision_exec.precision_jobs(SPEC),
            "precision_window": [runner.RankJob(
                "precision_window", WORLD,
                precision_exec.precision_rank_cells, PRECISION_WINDOW)],
            "geometry": geometry_exec.geometry_jobs(SPEC),
            "engine": runner.engine_jobs(EXEC_SOLVERS, ENGINES,
                                         n_shards=WORLD, **EXEC),
            "noisy": runner.noisy_jobs(
                EXEC_SOLVERS, dist, NOISY["noise_scale"], NOISY["n"],
                NOISY["maxiter"], NOISY["repeats"], NOISY["seed"], WORLD),
            "fault": fault_exec.fault_jobs(SPEC),
        }
        assert {j.world for js in jobs.values() for j in js} == {WORLD}
        flat = [j for js in jobs.values() for j in js]
        launches, seconds = {}, {}
        done = iter(runner.run_rank_jobs(flat, CPU, launches=launches,
                                         seconds=seconds))
        outs = {k: [next(done) for _ in js] for k, js in jobs.items()}
        port = {
            "engine": runner.run_engine_exec(
                EXEC_SOLVERS, ENGINES, device=CPU, n_shards=WORLD,
                sharded_outs=outs["engine"], **EXEC),
            "depth": runner.run_depth_exec(DEPTHS, EXEC["n"], DEPTH_ITERS,
                                           1, device=CPU),
            "noisy": runner.noisy_record(outs["noisy"]),
            "fault": fault_exec.fault_record(SPEC, outs["fault"]),
            "abft": abft_exec.abft_record(SPEC, outs["abft"]),
            "precision": precision_exec.precision_record(
                SPEC, outs["precision"], device=CPU),
            "precision_window": outs["precision_window"][0][0]["cells"],
            "geometry": geometry_exec.geometry_record(SPEC,
                                                      outs["geometry"]),
            "launches": launches, "seconds": seconds,
        }
    except BaseException:
        proc.kill()
        raise
    ref = R.finish(proc, out)
    return port, {k.split("/", 1)[1]: v for k, v in ref.items()
                  if k.startswith("campaign/")}


def _close(got, want, rtol):
    assert abs(got - want) <= rtol * abs(want), (got, want)


def test_one_spawn_ran_every_stage_on_the_plain_versions(stages):
    port, _ = stages
    assert set(port["seconds"]) == {"engine", "noisy", "fault", "abft",
                                    "precision", "precision_window",
                                    "geometry"}
    # CPU ranks take the kernels' plain versions: nothing launches
    assert all(v == 0 for counts in port["launches"].values()
               for v in counts.values())


def test_engine_cells_hold_the_naive_reference(stages):
    port, ref = stages
    want = {c["solver"]: c for c in ref["engine"]}
    bnorm = np.sqrt(EXEC["n"])
    cells = port["engine"]
    assert [(c["solver"], c["engine"]) for c in cells] == [
        (s, e) for s in EXEC_SOLVERS for e in ENGINES
        if e != "sharded_fused" or s in ("pipecg", "pipebicgstab")]
    for c in cells:
        w = want[c["solver"]]
        assert set(w) <= set(c)
        assert (c.get("n_shards") == WORLD) == (c["engine"]
                                                == "sharded_fused")
        _close(c["res_recurrence"], w["res_recurrence"], 1e-10)
        _close(c["res_true"], w["res_true"], 1e-10)
        assert abs(c["drift_rel"] - w["drift_rel"]) <= 1e-10
        assert c["per_iter_us"] > 0 and np.isfinite(c["per_iter_us"])
        assert c["res_true"] < 10 * bnorm ** 2


def test_depth_cells_hold_the_naive_reference(stages):
    port, ref = stages
    want = {c["l"]: c for c in ref["depth"]}
    assert [c["l"] for c in port["depth"]] == list(DEPTHS)
    for c in port["depth"]:
        w = want[c["l"]]
        assert set(w) == set(c) and c["engine"] == "fused"
        _close(c["res_recurrence"], w["res_recurrence"], 1e-10)
        _close(c["res_true"], w["res_true"], 1e-10)
        assert abs(c["drift_rel"] - w["drift_rel"]) <= 1e-10


def test_noisy_cells_inject_the_reference_waits(stages):
    port, ref = stages
    assert list(port["noisy"]) == list(EXEC_SOLVERS)
    for solver, c in port["noisy"].items():
        w = ref["noisy"][solver]
        assert set(w) == set(c)
        np.testing.assert_array_equal(np.sort(c["injected_waits"]),
                                      np.sort(w["injected_waits"]))
        assert len(c["run_times"]) == NOISY["repeats"]
        assert np.all(np.asarray(c["run_times"]) > 0)
        _close(c["res_norm"], w["res_norm"], 1e-10)
        _close(c["res_true"], w["res_true"], 1e-10)


FAULT_EQUAL = ("kind", "rate", "n_shards", "fault_shard", "onset_iter",
               "recovered", "converged", "executed_iters",
               "clean_executed_iters", "productive_iters", "n_shards_final",
               "detect_iters", "overhead_iters", "bound_iters",
               "overhead_ratio", "skipped")


def test_fault_stage_equals_the_reference(stages):
    port, ref = stages
    cells = port["fault"]["cells"]
    assert len(cells) == len(ref["fault"]["cells"]) == 3
    for got, want in zip(cells, ref["fault"]["cells"]):
        assert set(got) == set(want)
        assert {k: got[k] for k in FAULT_EQUAL} == {
            k: want[k] for k in FAULT_EQUAL}
        _close(got["true_res"], want["true_res"], 1e-6)
    vg, vw = (validate_fault_cells(c) for c in
              (cells, ref["fault"]["cells"]))
    for key in vw:
        for k in ("recovered", "converged", "accuracy_ok",
                  "within_bound_factor", "overhead_ratio",
                  "n_shards_final"):
            assert vg[key][k] == vw[key][k], (key, k)
        assert vg[key]["recovered"] and vg[key]["within_bound_factor"]


ABFT_EQUAL = ("solver", "detector", "magnitude", "onset_iter",
              "fault_shard", "trip_iter", "detect_lag_iters",
              "window_iters", "expect_trip", "tripped",
              "detected_in_window", "boundary_detect_iters",
              "clean_trip_iter", "false_positive", "converged", "skipped",
              "recovered", "recovery_detector", "recovery_detect_iters",
              "recovery_converged", "recovery_overhead_iters")


def test_abft_stage_equals_the_reference(stages):
    port, ref = stages
    cells = port["abft"]["cells"]
    assert len(cells) == len(ref["abft"]["cells"]) == 9
    for got, want in zip(cells, ref["abft"]["cells"]):
        assert set(got) == set(want)
        keys = [k for k in ABFT_EQUAL if k in want]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        _close(got["threshold"], want["threshold"], 1e-10)
        _close(got["modeled_detect_iters"], want["modeled_detect_iters"],
               1e-10)
    assert validate_abft_cells(cells).keys() == validate_abft_cells(
        ref["abft"]["cells"]).keys()
    rows = validate_abft_cells(cells).values()
    assert all(r["detection_ok"] and not r["false_positive"] for r in rows)
    assert all(r["recovery_ok"] for r in rows if "recovery_ok" in r)


def test_precision_stage_against_the_reference(stages):
    port, ref = stages
    cells = port["precision"]["cells"]
    want = ref["precision"]["cells"]
    assert [(c["solver"], c["policy"], c["expect"]) for c in cells] == [
        (c["solver"], c["policy"], c["expect"]) for c in want]
    for got, w in zip(cells, want):
        assert set(got) == set(w)
        # (``iters`` counts steps before the recurrence residual
        # underflows to zero at the plateau: past the H6 window, so not
        # held)
        for k in ("eps_storage", "floor_rel", "storage_words",
                  "wire_words"):
            assert got[k] == w[k], (got["policy"], k)
        if got["solver"] == "pipecg":
            # the plateaus agree to 1e-4 (1e-6 measured); the fp32 cell
            # sits at float64 rounding, far below its storage eps
            assert abs(got["true_res_rel"] - w["true_res_rel"]) <= \
                1e-4 * w["true_res_rel"] + 1e-6 * w["eps_storage"], (
                    got["policy"], got["true_res_rel"], w["true_res_rel"])
            assert got["precision_ok"] == w["precision_ok"]
            assert got["within_floor"] == w["within_floor"]
        else:   # H13: the drift past convergence, not the floor
            assert 0 < got["true_res_rel"] < 1.0
    # the plateaus keep their order, bf16 above fp32, and stay within a
    # factor of 10 of the reference's (3.6 and 1.9 measured): H8's drift
    plateau = {(c["solver"], c["policy"]): c["true_res_rel"] for c in cells}
    ref_plateau = {(c["solver"], c["policy"]): c["true_res_rel"]
                   for c in want}
    assert plateau["pipebicgstab", "bf16"] > plateau["pipebicgstab", "fp32"]
    for key, value in plateau.items():
        if key[0] == "pipebicgstab":
            assert ref_plateau[key] / 10 <= value <= 10 * ref_plateau[key]
    # inside the H6 window (12 iterations) each policy lands on the
    # reference's true residual: rtol 1e-10 of it plus 1e-6 of the storage
    # eps (the fp32 cell has reached float64 rounding there)
    win = {c["policy"]: c for c in ref["precision_window"]["cells"]}
    got_window = port["precision_window"]
    assert [c["policy"] for c in got_window] == list(win)
    for got in got_window:
        w = win[got["policy"]]
        assert got["iters"] == w["iters"] == 12
        assert abs(got["true_res_rel"] - w["true_res_rel"]) <= \
            1e-10 * w["true_res_rel"] + 1e-6 * w["eps_storage"], (
                got["policy"], got["true_res_rel"], w["true_res_rel"])
    assert win["bf16"]["true_res_rel"] > 1e4 * win["fp32"]["true_res_rel"]
    order = port["precision"]["order_bf16_int8wire"]
    assert order["overlap_ok"] and order["all_reduces_per_iter"] == 1.0
    assert ref["precision"]["hlo_bf16_int8wire"]["overlap_ok"]
    policies = tuple(SPEC.precision_policies)
    assert precision_exec.model_cells(policies, hw=HW, device=CPU) == \
        jprec.model_cells(policies)
    v = validate_precision_cells(port["precision"])
    assert v["split_phase"]["overlap_ok"] and v["noef_vs_ef"]["degrades"]


def test_geometry_stage_against_the_model_and_the_reference(stages):
    port, ref = stages
    cells = port["geometry"]["cells"]
    want = ref["geometry"]["cells"]
    assert [(c["format"], c["grid"]) for c in cells] == [
        (c["format"], c["grid"]) for c in want]
    cfg = {"points": list(SPEC.geometry_points), "bs": SPEC.geometry_bs}
    ops, _ = geometry_exec._problems(cfg, CPU)
    jops, _ = jgeom._problems(cfg)
    for got, w in zip(cells, want):
        geom = geometry_exec._cell_geometry(got["format"], got["grid"], cfg,
                                            ops[got["format"]], hw=HW)
        assert geom == jgeom._cell_geometry(w["format"], tuple(w["grid"]),
                                            cfg, jops[w["format"]])
        # the record prices the wire on the port's own H100 figures
        assert all(got[k] == v for k, v in geom.items()
                   if k != "t_halo_modeled_s")
        assert got["accuracy_err"] <= 1e-9
        assert got["all_reduces_per_iter"] == 1.0 and got["overlap_ok"]
        assert got["strip_sends_per_iter"] == got["strip_sends_expected"] \
            == w["ppermute_expected"]
        _close(got["res_norm"], w["res_norm"], 1e-6)
    v = validate_geometry_cells(cells)
    assert v["best_grid"]["matches_comm_model"]
    assert all(r["accuracy_ok"] and r["one_all_reduce"] and r["overlap_ok"]
               and r["strip_msgs_match"]
               for k, r in v.items() if k != "best_grid")
