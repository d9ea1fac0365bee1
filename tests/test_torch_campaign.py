"""The campaign's host stages and the block autotuner of the port, against
the JAX package on the same inputs.

- Discrete-event cells (``measured_makespans``, ``measured_s_sync_makespans``,
  ``measured_depth_makespans``): bit for bit (``t_sync``, ``t_pipe``,
  ``waits``) for uniform, exponential and lognormal noise, and for a
  recorded trace carried across from the JAX package; the port's own
  ``trace:`` noise is drawn by a torch generator, so its cells are held
  by statistics.
- ``fit_cell``: equal verdicts and family, fits and statistics to 1e-12
  on the same samples; the validators equal on the same cell lists
  (tests/test_campaign.py's synthetic fault, serve and geometry records,
  tests/test_abft.py's ABFT cells; geometry and precision under the
  port's renamed order-recorder fields).
- Report: the CSVs equal the reference's for the same result dict (the
  geometry CSV under its renamed columns), REPORT.md too, but for the
  port's own wording (``_WORDING``).
- ``run_campaign(TINY, skip_exec=True, device="cpu")`` with the JAX
  package's hardware fields equals the reference's record on every key
  but ``elapsed_s``, the trace-drawn cells and ``spec.serve_engine``
  (the port's default is ``fused``), to 1e-12; every acceptance check is
  true in both, and the port writes only under its out-dir.
- The autotuner: keys, hits and misses, ``clear_cache``, the JSON round
  trip; its modeled choice is ``sweep_plan``'s tile, table and shared
  memory for tridiagonal, ``laplacian_2d``, glen and
  convection-diffusion at float64 and float32 for both sweeps; one
  lookup per device plan built (``pipecg_spmv_fused.device_plan``), none
  per launch; a second identical-shape serve request is pure hits.
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.experiments.report as jreport
import repro.experiments.runner as jrunner
import repro.experiments.validation as jval
from repro.core.noise.simulator import Hardware as JHardware
from repro.experiments import CampaignSpec as JSpec
from repro.experiments import run_campaign as jrun_campaign
from repro.experiments.fitting import fit_cell as jfit_cell
from repro.experiments.noise_sources import \
    make_distribution as jmake_distribution
from repro_torch.convert import model_from_fields
from repro_torch.core.krylov import operators as tops
from repro_torch.core.noise.traces import EmpiricalDistribution
from repro_torch.experiments import report, runner, validation
from repro_torch.experiments.campaign import run_campaign
from repro_torch.experiments.fitting import fit_cell
from repro_torch.experiments.noise_sources import make_distribution
from repro_torch.experiments.spec import CampaignSpec
from repro_torch.kernels import autotune
from repro_torch.kernels import pipebicgstab_fused as bicg
from repro_torch.kernels import pipecg_spmv_fused as pcg
from test_abft import _fake_cell
from test_campaign import (_fault_cell, _geometry_cell, _geometry_cells,
                           _serve_record)

CPU = "cpu"
TINY = dict(
    name="tiny", solvers=("pipecg", "pgmres"), engines=("naive", "fused"),
    noises=("uniform", "exponential", "lognormal", "trace:PIPECG"),
    shard_counts=(2, 4), trials=32, iters=2000, fit_samples=1500,
    exec_solvers=("cg", "pipecg"), exec_n=512, exec_maxiter=10,
    exec_repeats=4, noise_scale=1e-3, depths=(1, 2, 4),
    depth_shard_counts=(4,), depth_exec_maxiter=20, fault_kinds=(),
    serve_requests=0, geometry_formats=(), seed=1234)
CLOSED = ("uniform", "exponential", "lognormal")
HW = model_from_fields("Hardware", dataclasses.asdict(JHardware()))
# REPORT.md lines the port words for itself (module and many-rank names)
_WORDING = {
    "`python -m repro.experiments.campaign --preset ":
        "`python -m repro_torch.experiments.campaign --preset ",
    "Real shard_map solves": "Real many-rank solves",
    "One fault per cell injected into a REAL multi-device shard_map":
        "One fault per cell injected into a REAL many-rank sharded",
    "solve (subprocess with forced host devices); the elastic":
        "solve (spawned ranks); the elastic",
    "survivor mesh for kill/corrupt": "survivor group for kill/corrupt",
}
# the reference's ABFT note names the change that brought the boundary
# check; the port's says what it is
_BOUNDARY = (re.compile(r"`boundary` is .*'s segment-boundary"),
             "`boundary` is the segment-boundary")


# -- discrete-event cells ---------------------------------------------------

@pytest.mark.parametrize("noise", CLOSED)
@pytest.mark.parametrize("P", [2, 8])
def test_discrete_event_cells_bit_for_bit(noise, P):
    dist, jdist = make_distribution(noise), jmake_distribution(noise)
    got = runner.measured_makespans(dist, P, 300, 40, seed=7,
                                    fit_samples=500)
    want = jrunner.measured_makespans(jdist, P, 300, 40, seed=7,
                                      fit_samples=500)
    for k in ("t_sync", "t_pipe", "waits"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.trials_effective == want.trials_effective
    assert got.speedup == want.speedup
    for s in (2, 4):
        g = runner.measured_s_sync_makespans(dist, P, 200, 32, s, 2.0,
                                             seed=3)
        w = jrunner.measured_s_sync_makespans(jdist, P, 200, 32, s, 2.0,
                                              seed=3)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    for lag in (1, 2, 4):
        g = runner.measured_depth_makespans(dist, P, 200, 32, lag, 2.0,
                                            seed=5)
        w = jrunner.measured_depth_makespans(jdist, P, 200, 32, lag, 2.0,
                                             seed=5)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_trace_cells_carried_across_bit_for_bit_and_drawn_by_statistics():
    jdist = jmake_distribution("trace:PIPECG", seed=1234)
    carried = EmpiricalDistribution.from_samples(jdist.samples,
                                                 jdist.trace_name)
    got = runner.measured_makespans(carried, 4, 400, 32, seed=11)
    want = jrunner.measured_makespans(jdist, 4, 400, 32, seed=11)
    for k in ("t_sync", "t_pipe", "waits"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    # the port's own trace: Table-1 runs drawn by its torch generator
    own = runner.measured_makespans(
        make_distribution("trace:PIPECG", seed=1234, device=CPU), 4, 400,
        32, seed=11)
    assert abs(own.waits.mean() / want.waits.mean() - 1) < 0.05
    assert abs(own.speedup / want.speedup - 1) < 0.05


# -- fitting and validation ---------------------------------------------------

def _close_tree(got, want, rtol=1e-12, path=""):
    """Equal structure; floats to ``rtol``, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close_tree(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(
            want, bool):
        assert abs(float(got) - float(want)) <= rtol * abs(float(want)) \
            or (np.isnan(want) and np.isnan(got)), (path, got, want)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("noise", CLOSED)
def test_fit_cell_equals_the_reference(noise):
    rng = np.random.default_rng(17)
    x = {"uniform": rng.uniform(0.0, 1.0, 1500),
         "exponential": rng.exponential(1.0, 1500),
         "lognormal": rng.lognormal(0.0, 1.0, 1500)}[noise]
    got, want = fit_cell(x, name=noise), jfit_cell(x, name=noise)
    assert got["best_family"] == want["best_family"]
    assert got["verdicts"] == want["verdicts"]
    _close_tree(got, want)


def _precision_record(key):
    """A synthetic precision-stage record; ``key`` names its split-phase
    entry (``hlo_bf16_int8wire`` in the JAX package, the port's order
    recorder's ``order_bf16_int8wire``)."""
    def cell(solver, policy, expect, res, eps, floor):
        return {"solver": solver, "policy": policy, "expect": expect,
                "expect_safe": expect == "safe", "iters": 300,
                "true_res_rel": res, "eps_storage": eps, "floor_rel": floor,
                "res_over_eps": res / eps, "within_floor": res <= floor,
                "precision_ok": (res <= floor) == (expect != "unsafe"),
                "storage_words": 0.5, "wire_words": 0.25, "skipped": False}
    return {"cells": [cell("pipecg", "bf16_int8wire", "safe", 4.9e-3,
                           7.8e-3, 1.56e-2),
                      cell("pipecg", "bf16_int8wire_noef", "degraded",
                           5.4e-3, 7.8e-3, 1.56e-2),
                      cell("pipecg", "bf16_int8allwire", "unsafe", 4.8,
                           7.8e-3, 1.56e-2)],
            key: {"overlap_ok": True},
            "model": {"fp32": {"speedup": 2.4, "pipe_latency_bound": 0.0},
                      "bf16": {"speedup": 3.6, "pipe_latency_bound": 1.0}}}


def _port_geometry(cells):
    """The reference's synthetic geometry cells under the port's fields."""
    out = []
    for c in cells:
        c = dict(c)
        c["all_reduces_per_iter"] = float(c.pop("hlo_all_reduce"))
        c["strip_sends_per_iter"] = float(c.pop("hlo_ppermute"))
        c["strip_sends_expected"] = c.pop("ppermute_expected")
        c["overlap_ok"] = c["overlap_ok"] and not c.pop(
            "permute_depends_on_reduce")
        out.append(c)
    return out


_RENAMED = {"hlo_msgs_match": "strip_msgs_match"}


def test_validators_equal_the_reference():
    faults = [_fault_cell(), _fault_cell(kind="stall", overhead_iters=3.0,
                                         overhead_ratio=3.0 / 5.5),
              _fault_cell(kind="corrupt", recovered=False),
              _fault_cell(skipped=True)]
    assert validation.validate_fault_cells(faults) == \
        jval.validate_fault_cells(faults)
    for serve in (_serve_record(), {}, _serve_record(
            burst={**_serve_record()["burst"], "throughput_speedup": 1.5})):
        assert validation.validate_serve_cells(serve) == \
            jval.validate_serve_cells(serve)
    abft = [_fake_cell(recovered=True, recovery_detector="checksum",
                       recovery_converged=True, recovery_detect_iters=1.0),
            _fake_cell(solver="pipecg_l", detector="state_deviation",
                       window_iters=3),
            _fake_cell(magnitude=1e-12, expect_trip=False, tripped=False,
                       trip_iter=-1, detect_lag_iters=-1,
                       detected_in_window=False),
            _fake_cell(false_positive=True)]
    assert validation.validate_abft_cells(abft) == \
        jval.validate_abft_cells(abft)
    got = validation.validate_precision_cells(
        _precision_record("order_bf16_int8wire"))
    want = jval.validate_precision_cells(
        _precision_record("hlo_bf16_int8wire"))
    want["split_phase"] = want.pop("hlo")
    assert got == want
    for cells in (_geometry_cells(),
                  [_geometry_cell(hlo_all_reduce=2)],
                  [_geometry_cell(permute_depends_on_reduce=True)],
                  [_geometry_cell(hlo_ppermute=4)],
                  [_geometry_cell(accuracy_err=1e-5)]):
        got = validation.validate_geometry_cells(_port_geometry(cells))
        want = jval.validate_geometry_cells(cells)
        for row in want.values():
            for k, v in _RENAMED.items():
                if k in row:
                    row[v] = row.pop(k)
        assert got == want


# -- the whole campaign without execution, and its report ------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(port result, reference result, port out-dir, reference out-dir)."""
    out = tmp_path_factory.mktemp("port")
    jout = tmp_path_factory.mktemp("ref")
    got = run_campaign(CampaignSpec(**TINY), out_dir=out / "campaign",
                       skip_exec=True, device=CPU, hw=HW)
    want = jrun_campaign(JSpec(**TINY), out_dir=jout, skip_exec=True)
    return got, want, out, jout


def _not_trace(cells):
    return [c for c in cells if not c["noise"].startswith("trace:")]


def test_skip_exec_campaign_matches_the_reference(tiny):
    got, want, _, _ = tiny
    assert set(got) == set(want)
    spec = dict(want["spec"], serve_engine="fused")
    assert json.loads(json.dumps(got["spec"])) == json.loads(json.dumps(spec))
    for key in ("cells", "depth_cells", "sync_cells"):
        _close_tree(_not_trace(got[key]), _not_trace(want[key]))
        assert len(got[key]) == len(want[key])
    for noise in CLOSED:
        _close_tree(got["wait_fits"][noise], want["wait_fits"][noise])
    gv, wv = got["validation"], want["validation"]
    assert set(gv) == set(wv)
    for key in ("depth", "s_sync", "per_noise", "folk_2x"):
        src_g = gv[key] if key in gv else gv
        src_w = wv[key] if key in wv else wv
        for row in src_w:
            if not row.startswith("trace:"):
                _close_tree(src_g[row], src_w[row])
    assert gv["acceptance"] == wv["acceptance"]
    assert all(gv["acceptance"].values())
    for key in ("engine_exec", "sharded_exec", "depth_exec", "noisy_exec",
                "runtime_fits", "fault_cells", "serve", "abft_cells",
                "abft", "precision_cells", "precision_model", "precision",
                "geometry_cells", "recovery"):
        assert got[key] == want[key], key


def test_campaign_writes_only_under_its_out_dir(tiny):
    _, _, out, _ = tiny
    files = sorted(p.relative_to(out).as_posix() for p in out.rglob("*")
                   if p.is_file())
    assert files == sorted(
        ["campaign/REPORT.md", "campaign/campaign.json"]
        + [f"campaign/figures/{f}" for f in (
            "campaign_speedup.csv", "campaign_depth.csv",
            "campaign_sync.csv", "campaign_ecdf_uniform.csv",
            "campaign_ecdf_exponential.csv", "campaign_ecdf_lognormal.csv",
            "campaign_ecdf_trace_pipecg.csv")])
    rec = json.loads((out / "campaign" / "campaign.json").read_text())
    assert rec["spec"]["name"] == "tiny"


def _closed_only(result):
    """The reference's result dict without its trace-drawn rows, plus
    synthetic fault, serve and ABFT records, so that both packages
    render the same numbers."""
    res = json.loads(json.dumps(jreport._jsonable(result)))
    res["spec"]["noises"] = list(CLOSED)
    for key in ("cells", "depth_cells", "sync_cells"):
        res[key] = _not_trace(res[key])
    for key in ("wait_fits",):
        res[key] = {k: v for k, v in res[key].items() if k in CLOSED}
    v = res["validation"]
    for key in ("per_noise", "folk_2x"):
        v[key] = {k: r for k, r in v[key].items() if k in CLOSED}
    for key in ("depth", "s_sync"):
        v[key] = {k: r for k, r in v[key].items()
                  if not k.startswith("trace:")}
    res["fault_cells"] = [_fault_cell()]
    v["fault"] = jval.validate_fault_cells(res["fault_cells"])
    base = _serve_record()
    res["serve"] = _serve_record(
        burst={**base["burst"], "n_requests": 16, "n": 256, "k_slots": 8,
               "engine": "fused"},
        paced={**base["paced"], "arrival": "poisson"})
    v["serve"] = jval.validate_serve_cells(res["serve"])
    res["abft_cells"] = [_fake_cell()]
    v["abft"] = jval.validate_abft_cells(res["abft_cells"])
    return res


def test_report_csvs_and_markdown_equal_the_reference(tiny, tmp_path):
    _, want, _, _ = tiny
    res = _closed_only(want)
    mine, ref = tmp_path / "port", tmp_path / "ref"
    for mod, d in ((report, mine), (jreport, ref)):
        mod.write_speedup_csv(d, res["cells"])
        mod.write_depth_csv(d, res["depth_cells"])
        mod.write_sync_csv(d, res["sync_cells"])
        mod.write_fault_csv(d, res["fault_cells"])
        mod.write_serve_csv(d, res["serve"])
        mod.write_abft_csv(d, res["abft_cells"])
        mod.write_precision_csv(d, _precision_record("x")["cells"])
        mod.write_runtimes_csv(d, {"cg": {"run_times": [0.5, 0.25]}})
        mod.write_ecdf_csv(d, "exponential", np.random.default_rng(
            3).exponential(1.0, 300))
        mod.write_report_md(d, res)
    for f in sorted((ref / "figures").iterdir()):
        assert (mine / "figures" / f.name).read_text() == f.read_text(), \
            f.name
    text = (ref / "REPORT.md").read_text()
    for old, new in _WORDING.items():
        text = text.replace(old, new)
    text = _BOUNDARY[0].sub(_BOUNDARY[1], text)
    assert (mine / "REPORT.md").read_text() == text
    # the geometry CSV: the reference's rows under the port's columns
    report.write_geometry_csv(mine, _port_geometry(_geometry_cells()))
    jreport.write_geometry_csv(ref, _geometry_cells())
    g = (mine / "figures" / "campaign_geometry.csv").read_text().splitlines()
    w = (ref / "figures" / "campaign_geometry.csv").read_text().splitlines()
    assert g[0] == report.GEOMETRY_CSV_HEADER
    cols = report.GEOMETRY_CSV_HEADER.split(",")
    for gl, wl in zip(g[1:], w[1:]):
        gv, wv = gl.split(","), wl.split(",")
        for name, a, b in zip(cols, gv, wv):
            if name.endswith("_per_iter"):
                assert float(a) == float(b), name
            else:
                assert a == b, name
    assert len(g) == len(w)


# -- the block autotuner ----------------------------------------------------

def test_autotune_keys_hits_misses_and_clear():
    autotune.clear_cache()
    kw = dict(words_per_row=6.0, min_block=2, device=CPU)
    b1 = autotune.best_block("serve_test", 4096, torch.float64, **kw)
    assert autotune.cache_stats() == {"hits": 0, "misses": 1}
    b2 = autotune.best_block("serve_test", 4096, torch.float64, **kw)
    assert autotune.cache_stats() == {"hits": 1, "misses": 1} and b1 == b2
    # every part of the key separates choices
    for over in (dict(n_shards=4), dict(k_rhs=8), dict(min_block=4),
                 dict(dtype_storage=torch.bfloat16), dict(fmt="bsr"),
                 dict(offsets=(-1, 0, 1))):
        autotune.best_block("serve_test", 4096, torch.float64,
                            **{**kw, **over})
    autotune.best_block("serve_test", 4096, torch.float32, **kw)
    autotune.best_block("serve_test", 2048, torch.float64, **kw)
    assert autotune.cache_stats() == {"hits": 1, "misses": 9}
    key = autotune._key("serve_test", 4096, torch.float64, "cpu", 2, 1, 1)
    assert key == "serve_test|4096|float64|cpu|2|1|1"
    assert autotune.scores(key)[0][1] == 256
    # modeled words: equal traffic, fewer steps win (the largest block)
    assert b1 == 4096
    autotune.clear_cache()
    assert autotune.cache_stats() == {"hits": 0, "misses": 0}
    assert autotune.scores(key) == []


def test_autotune_cache_round_trip(tmp_path):
    autotune.clear_cache()
    autotune.best_block("a", 1000, torch.float64, words_per_row=3.0,
                        device=CPU)
    cap = autotune.sweep_tile_cap("pipecg", (-1, 0, 1), 4096, torch.float64,
                                  device=CPU)
    path = autotune.save_cache(str(tmp_path / "d" / "cache.json"))
    data = json.loads(Path(path).read_text())
    assert data["version"] == 1 and len(data["blocks"]) == 2
    autotune.clear_cache()
    assert autotune.load_cache(path) == 2
    again = autotune.sweep_tile_cap("pipecg", (-1, 0, 1), 4096,
                                    torch.float64, device=CPU)
    assert again == cap and autotune.cache_stats() == {"hits": 1,
                                                       "misses": 0}
    assert autotune.load_cache(str(tmp_path / "missing.json")) == 0
    assert Path(autotune.DEFAULT_CACHE_PATH).parts[-3:] == (
        "build", "repro_torch", "autotune_cache.json")
    autotune.clear_cache()


OPERATORS = {
    "tridiagonal": lambda: tops.tridiagonal_laplacian(4096, device=CPU),
    "laplacian_2d": lambda: tops.laplacian_2d(64, 64, device=CPU),
    "glen": lambda: tops.glen_law_band(4096, device=CPU),
    "convection_diffusion": lambda: tops.convection_diffusion(4096,
                                                              device=CPU),
}


@pytest.mark.parametrize("name", list(OPERATORS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_modeled_choice_is_todays_sweep_plan(name, dtype):
    A = OPERATORS[name]()
    acc = torch.empty((), dtype=dtype).element_size()
    autotune.clear_cache()
    for sweep, plan, default in (("pipecg", pcg.sweep_plan, pcg.SWEEP_TILE),
                                 ("pipebicgstab", bicg.sweep_plan,
                                  bicg.BICG_TILE)):
        cap = autotune.sweep_tile_cap(sweep, A.offsets, A.n, dtype,
                                      device=CPU)
        assert cap == default
        assert plan(A.offsets, acc, cap) == plan(A.offsets, acc)
        assert max(autotune.sweep_candidates(sweep)) == default
    assert autotune.cache_stats()["misses"] == 2
    autotune.clear_cache()


def test_one_lookup_per_prepared_solve_none_per_launch():
    """The tile cap is looked up when a sweep's device plan is built (once
    per operator, shape, dtypes and device), never at a launch that reuses
    the plan; the plain versions on the CPU build no plan."""
    from repro_torch.core.krylov import pipebicgstab, pipecg
    autotune.clear_cache()
    offsets, n = (-1, 0, 1), 777          # a shape no other test plans
    x = torch.zeros((1, n), dtype=torch.float64)
    first = pcg.device_plan(pcg.sweep_plan, offsets, x)
    assert autotune.cache_stats() == {"hits": 0, "misses": 1}
    assert pcg.device_plan(pcg.sweep_plan, offsets, x) is first
    assert autotune.cache_stats() == {"hits": 0, "misses": 1}
    tile, table, smem = first
    assert (tile, table.tolist(), smem) == pcg.sweep_plan(offsets, 8)
    bicg_plan = pcg.device_plan(bicg.sweep_plan, offsets, x[0])
    assert autotune.cache_stats() == {"hits": 0, "misses": 2}
    assert bicg_plan[0] == bicg.sweep_plan(offsets, 8)[0]
    # a caller's cap (the measured regime's probe) looks nothing up
    capped = pcg.device_plan(pcg.sweep_plan, offsets, x, max_tile=256)
    assert capped[0] <= 256 and autotune.cache_stats()["misses"] == 2
    # k = 8 right-hand sides and float32 storage are plans of their own
    pcg.device_plan(pcg.sweep_plan, offsets, x.expand(8, n))
    pcg.device_plan(pcg.sweep_plan, offsets, x, None, torch.float32)
    assert autotune.cache_stats() == {"hits": 0, "misses": 4}
    A = tops.tridiagonal_laplacian(300, device=CPU)
    b = torch.ones(300, dtype=torch.float64)
    pipecg(A, b, maxiter=30, engine="fused")
    pipebicgstab(A, b, maxiter=20, engine="fused")
    assert autotune.cache_stats() == {"hits": 0, "misses": 4}
    autotune.clear_cache()


def test_second_identical_shape_serve_request_is_pure_hits():
    """The reference's warm-reuse pin (tests/test_serve.py): a second
    server over a same-shape operator re-tunes nothing.  On the CPU the
    batcher's step takes the plain sweep and tunes nothing at all; the
    plan the card builds for that step's (k, n) rows is looked up once,
    whatever the coefficients (test_torch_cuda.py serves it there)."""
    from repro_torch.serve import SolverServer, synthetic_requests
    from repro_torch.serve.batcher import clear_compile_cache

    clear_compile_cache()
    autotune.clear_cache()
    n = 96
    A = tops.tridiagonal_laplacian(n, device=CPU)
    reqs = synthetic_requests(A, 1, tol=1e-8, maxiter=200, modes=(4, 16),
                              seed=3)

    def serve(reqs):
        srv = SolverServer(k_slots=2, engine="fused", step_block=8)
        srv.submit_all(list(reqs))
        return srv.run()
    assert serve(reqs).n_converged == 1
    assert autotune.cache_stats() == {"hits": 0, "misses": 0}
    step_rows = torch.zeros((2, n), dtype=torch.float64)
    pcg.device_plan(pcg.sweep_plan, A.offsets, step_rows)
    cold = autotune.cache_stats()
    A2 = tops.DiaMatrix(offsets=A.offsets, bands=A.bands * 1.5)
    assert serve(synthetic_requests(A2, 1, tol=1e-8, maxiter=200,
                                    modes=(4, 16), seed=4)).n_converged == 1
    pcg.device_plan(pcg.sweep_plan, A2.offsets, step_rows)
    assert autotune.cache_stats() == cold
    clear_compile_cache()
    autotune.clear_cache()
