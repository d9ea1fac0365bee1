"""Campaign geometry stage: operator format x process grid x noise (the
JAX package's ``experiments/geometry_exec.py``).

Sweeps the operator-layer decompositions — DIA on a 1-D chain, BSR on a
1-D block chain, DIA on a 2-D process grid — over REAL many-rank solves
and validates each against the surface-to-volume communication model
(``core/perfmodel/comm.py``).  The cells of one process count P run in
one spawn of P ranks (``distributed/ranks.py``; the JAX package forces
host devices in a subprocess).

Per cell every rank runs ``distributed_solve(engine="sharded_fused")`` on
the format's shifted-Laplacian problem and records

* accuracy — max |x_sharded - x_ref| against a one-device PIPECG of the
  same operator (a matvec callable, the JAX package's reference);
* the collectives its iterations issued, from the order recorder
  (``distributed/overlap.py::CountingRecorder``; the JAX package counts
  them in compiled HLO, which the port has not, ROADMAP.md H5):
  ``all_reduces_per_iter`` (split-phase issues and blocking calls after
  the set-up, per iteration, on the busiest rank: exactly ONE),
  ``overlap_ok`` (``split_phase_ok`` on every rank), and
  ``strip_sends_per_iter``, the strips the group sends per iteration by
  vector and face (each face counted on the rank that sends most across
  it), which must equal ``strip_sends_expected = n_halo_vecs *
  halo_messages(1) * active_dims`` — the measured-vs-modeled
  message-count gate (a size-1 grid axis has no neighbour, so nothing
  crosses it and the model does not count it);
* per-iteration wall time, clean and with a wall-clock ``NoiseHook``
  stall per iteration (the noise axis of the sweep);
* the modeled geometry terms: ``halo_elems``, ``surface_to_volume`` and
  ``halo_wire_time`` for the cell's local tile extents.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

# halo-carrying vectors per pipelined iteration (u and p — what every
# sharded body exchanges at double reach for the recompute trick)
_N_HALO_VECS = 2


def _problems(cfg: Dict, device="cuda"):
    """Build the per-format operator table and b once."""
    from repro_torch.core.krylov import dia_to_bsr, laplacian_2d
    from repro_torch.core.krylov.operators import DiaMatrix
    from repro_torch.experiments.fault_exec import _shifted_laplacian

    ny, nx = (int(v) for v in cfg["points"])
    n = ny * nx
    A1 = _shifted_laplacian(n, device=device)
    A2d0 = laplacian_2d(nx=nx, ny=ny, device=device)
    bands = A2d0.bands.clone()
    bands[A2d0.offsets.index(0)] += 1.0
    A2d = DiaMatrix(offsets=A2d0.offsets, bands=bands,
                    grid_shape=A2d0.grid_shape)
    Ab = dia_to_bsr(A1, bs=int(cfg["bs"]))
    b = torch.ones((n,), dtype=A1.dtype, device=device)
    return {"dia": A1, "dia2d": A2d, "bsr": Ab}, b


def _cell_geometry(fmt: str, grid, cfg: Dict, A, hw=None) -> Dict:
    """Modeled comm terms for one cell's local tile (comm.py surface law);
    ``hw`` (default the port's H100 ``Hardware()``) prices the wire."""
    from repro_torch.core.noise.simulator import Hardware
    from repro_torch.core.perfmodel import comm

    ny, nx = (int(v) for v in cfg["points"])
    n = ny * nx
    if fmt == "dia2d":
        extents = comm.local_extents((ny, nx), tuple(grid))
        hs = A.halo_spec()          # N/S/W/E strip widths
        widths = (hs.widths[0], hs.widths[2])
    elif fmt == "bsr":
        # the wire moves block rows: block_halo * bs elements per side
        extents = (n // int(grid[0]),)
        widths = (A.block_halo * A.bs,)
    else:
        extents = (n // int(grid[0]),)
        widths = (max(abs(o) for o in A.offsets),)
    hw = Hardware() if hw is None else hw
    # a size-1 grid axis has no neighbour: nothing crosses it, so the
    # message gate only counts the decomposed (active) dimensions
    active = sum(1 for g in grid if int(g) > 1)
    return {
        "extents": list(extents),
        "widths": list(widths),
        "halo_elems": comm.halo_elems(extents, widths),
        "surface_to_volume": comm.surface_to_volume(extents, widths),
        "msgs_modeled": comm.halo_messages(len(extents)),
        "msgs_active": comm.halo_messages(1) * active,
        "t_halo_modeled_s": comm.halo_wire_time(
            extents, widths, n_halo_vecs=_N_HALO_VECS, dtype_bytes=8,
            link_bw=hw.link_bw, hop_latency=hw.hop_latency),
    }


def _group_counts(rec, iterations: int, world: int) -> Dict:
    """The order recorder's loop counts over the group: all-reduces per
    iteration on the busiest rank, the split-phase order on every rank,
    and the strips sent per iteration by face, each face counted on the
    rank that sends most across it."""
    import torch.distributed as dist

    from repro_torch.distributed.overlap import split_phase_ok

    loop = rec.loop_counts()
    mine = {"ok": split_phase_ok(rec.events, iterations),
            "reduces": (loop["issues"] + loop["blocking"]) / iterations,
            "sends": {f: c / iterations for f, c in loop["sends"].items()}}
    every = [None] * world
    dist.all_gather_object(every, mine)
    faces: Dict[str, float] = {}
    for r in every:
        for face, c in r["sends"].items():
            faces[face] = max(faces.get(face, 0.0), c)
    return {"all_reduces_per_iter": max(r["reduces"] for r in every),
            "overlap_ok": all(r["ok"] for r in every),
            "strip_sends_per_iter": sum(faces.values()),
            "strip_sends_by_face": dict(sorted(faces.items()))}


def geometry_rank_cells(rank: int, world: int, cfg: Dict,
                        device: str = "cuda") -> Dict:
    """Rank body: every ``(ci, cell)`` of ``cfg["cells"]`` (all of this
    world's P) on the whole group; rank 0's cells and this rank's kernel
    launches."""
    import torch.distributed as dist

    from repro_torch.core.krylov import distributed_solve, pipecg
    from repro_torch.core.noise.injection import NoiseHook
    from repro_torch.core.perfmodel.distributions import Exponential
    from repro_torch.distributed.overlap import CountingRecorder
    from repro_torch.kernels import ops

    maxiter = int(cfg["maxiter"])
    tol = float(cfg["tol"])
    repeats = int(cfg["repeats"])
    noise_scale = float(cfg["noise_scale"])
    seed = int(cfg["seed"])
    probs, b = _problems(cfg, device)
    ops.reset_launch_counts()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    refs: Dict[str, object] = {}
    cells: List = []
    for ci, cell in cfg["cells"]:
        fmt = cell["format"]
        grid = tuple(int(g) for g in cell["grid"])
        P = math.prod(grid)
        A = probs[fmt]
        if fmt not in refs:
            refs[fmt] = pipecg(lambda v, A=A: A.matvec(v), b,
                               maxiter=maxiter, tol=tol)
        ref = refs[fmt]
        group = (None, grid) if fmt == "dia2d" else None

        def solve(noise=None, recorder=None):
            return distributed_solve(pipecg, A, b, group,
                                     engine="sharded_fused",
                                     maxiter=maxiter, tol=tol,
                                     noise=noise, recorder=recorder)
        rec = CountingRecorder()
        out = solve(recorder=rec)
        counts = _group_counts(rec, maxiter, world)
        err = float(torch.max(torch.abs(out.x - ref.x)))
        times = []
        for _ in range(repeats):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            solve()
            sync()
            times.append(time.perf_counter() - t0)
        t_iter = min(times) / maxiter

        hook = NoiseHook(Exponential(1.0), scale=noise_scale,
                         seed=seed + 13 * ci)
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        solve(noise=hook)
        sync()
        t_iter_noisy = (time.perf_counter() - t0) / maxiter
        t = torch.tensor([t_iter, t_iter_noisy], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)   # the slowest rank's

        geom = _cell_geometry(fmt, grid, cfg, A)
        cells.append((ci, {
            "format": fmt, "grid": list(grid), "P": P,
            "res_norm": float(out.res_norm),
            "ref_res_norm": float(ref.res_norm),
            "accuracy_err": err,
            "t_iter_us": float(t[0]) * 1e6,
            "t_iter_noisy_us": float(t[1]) * 1e6,
            "strip_sends_expected": _N_HALO_VECS * geom["msgs_active"],
            "skipped": False,
            **geom, **counts,
        }))
    return {"cells": cells if rank == 0 else [],
            "launches": ops.launch_counts()}


def stage_cells(spec) -> List[Dict]:
    """The (format, grid) cells of ``spec``."""
    cells = []
    for fmt in spec.geometry_formats:
        if fmt == "dia2d":
            cells.extend({"format": fmt, "grid": list(g)}
                         for g in spec.geometry_grids)
        else:
            cells.append({"format": fmt,
                          "grid": [int(spec.geometry_shards)]})
    return cells


def geometry_jobs(spec) -> List:
    """The stage's rank jobs: one per process count, with its cells."""
    from repro_torch.experiments.runner import RankJob

    if not spec.geometry_formats:
        return []
    cells = stage_cells(spec)
    cfg = {
        "points": list(spec.geometry_points),
        "maxiter": spec.geometry_maxiter, "tol": spec.geometry_tol,
        "repeats": spec.geometry_repeats, "bs": spec.geometry_bs,
        "noise_scale": spec.geometry_noise_scale, "seed": spec.seed,
    }
    return [RankJob("geometry", P, geometry_rank_cells, dict(
                cfg, cells=[(ci, c) for ci, c in enumerate(cells)
                            if math.prod(c["grid"]) == P]))
            for P in dict.fromkeys(math.prod(c["grid"]) for c in cells)]


def geometry_record(spec, outs: List[List[Dict]]) -> Dict:
    """The stage's record from its jobs' per-rank outputs."""
    if not spec.geometry_formats:
        return {"cells": []}
    by_ci: Dict[int, Dict] = {}
    for per_rank in outs:
        by_ci.update(dict(per_rank[0]["cells"]))
    return {"cells": [by_ci[ci] for ci in range(len(by_ci))],
            "points": list(spec.geometry_points),
            "maxiter": spec.geometry_maxiter, "tol": spec.geometry_tol,
            "noise_scale": spec.geometry_noise_scale,
            "bs": spec.geometry_bs}
