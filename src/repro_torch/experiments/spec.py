"""Campaign specification + presets (a copy of the JAX package's
``experiments/spec.py``; one default differs: ``serve_engine``).

A ``CampaignSpec`` fixes the full experimental grid: which pipelined
solvers (each measured against its classical partner), which iteration
engines, which waiting-time distributions (closed-form families of the
paper's §3 plus recorded traces), which shard counts P, and how many
repeated trials / iterations each cell runs.

Units: all times are seconds; ``noise_scale`` converts dimensionless
distribution draws into seconds for the wall-clock injection runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# pipelined solver -> the classical partner its speedup is measured against
SOLVER_PAIRS: Dict[str, str] = {"pipecg": "cg", "pipecr": "cr",
                                "pgmres": "gmres",
                                "pipebicgstab": "bicgstab"}


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Full experimental grid for one campaign run.

    Attributes
    ----------
    name:
        Preset name (appears in every emitted artifact).
    solvers:
        Pipelined solvers to sweep; each is validated against
        ``SOLVER_PAIRS[solver]``.
    engines:
        Iteration engines for the execution stage
        (``core/krylov/engine.py`` registry names).  ``"sharded_fused"``
        routes the solve through ``distributed_solve`` over every local
        device (halo-aware single-sweep kernel + split-phase psum); the
        runner skips solver/engine combinations an engine cannot express
        (the sharded engine covers pipecg / pipecg_multi / pipecr).
    noises:
        Waiting-time distribution names understood by
        ``noise_sources.make_distribution`` — closed-form families
        (``uniform`` / ``exponential`` / ``lognormal``) or recorded traces
        (``trace:PIPECG`` etc., resolved via ``core/noise/traces.py``).
    shard_counts:
        Process counts P for the discrete-event stage.
    trials:
        Repeated Monte-Carlo trials per (noise, P) cell.  At very large P
        the runner scales this down (memory/time) and records the
        effective count.
    iters:
        Krylov iterations per trial (the paper forces 5000).
    fit_samples:
        Number of recorded wait samples kept per noise for the fitting
        stage.
    exec_solvers:
        Solvers for the real (wall-clock, shard_map) execution stage.
    exec_n / exec_maxiter / exec_repeats:
        Problem size, iteration count and repeat count of the execution
        stage.
    exec_noise:
        Which of ``noises`` is wall-clock-injected in the execution stage.
    noise_scale:
        Seconds per unit draw for the wall-clock injection (1.5e-3 makes a
        unit-mean exponential inject ~1.5 ms of stall per iteration).
    depths:
        Pipeline depths l for the depth sweep (lag-l makespans, depth-l
        real solves); the depth acceptance grid is (1, 2, 4).
    depth_shard_counts:
        Process counts for the depth sweep (a subset of the main grid —
        each lag-l cell is a sequential discrete-event recursion).
    depth_red_latency:
        Reduction latency R for the depth sweep, in units of the
        waiting-time mean — the latency-dominated regime where depth
        matters (the paper's ex23: "most time in dot products").
    depth_exec_maxiter:
        Iteration count of the real ``pipecg_l`` execution cells.
    sync_counts:
        Synchronization counts s for the s-sync sweep (CG exposes 2 per
        iteration, classical BiCGStab 4 — the >2x ceiling family;
        core/perfmodel/sync.py).
    sync_shard_counts:
        Process counts for the s-sync sweep.
    sync_red_latency:
        Reduction latency R for the s-sync sweep, in units of the
        waiting-time mean (the latency-dominated regime where the sync
        count matters).
    abft_solvers:
        Sharded solvers swept by the ABFT detection-coverage stage
        (subset of {"pipecg", "pipebicgstab", "pipecg_l"}; empty tuple
        disables the stage).  Each cell injects one silent ``corrupt``
        fault of a given magnitude into a real multi-device shard_map
        solve and measures the in-flight checksum detector: detection
        latency (iterations from onset to trip), false positives on the
        clean twin run, and — for pipecg — the elastic controller's
        recovery overhead with the fast path active, all against the
        ``core/perfmodel/resync.py`` ABFT detection model.
    abft_magnitudes:
        Corruption magnitudes swept (FaultSpec ``magnitude=``); the
        smallest should sit near the checksum trip threshold so the
        sweep covers both the sub-threshold (slow-path) and the
        supra-threshold (one-iteration) detection regimes.
    abft_n / abft_shards / abft_maxiter / abft_tol:
        Problem size, mesh size, iteration cap and tolerance of each
        ABFT-stage solve (same shifted Laplacian as the fault stage).
    abft_depth:
        Ghost-basis depth l of the ``pipecg_l`` cell — its detection
        window is l iterations (block-granular reductions).
    fault_kinds:
        Fault kinds for the elastic-recovery stage (subset of
        ``core/noise/faults.FAULT_KINDS``; empty tuple disables the
        stage).  Each cell injects ONE fault of that kind into a real
        multi-device shard_map solve (subprocess, forced host devices)
        and measures the recovery overhead of
        ``distributed/fault.resilient_distributed_solve`` against the
        ``core/perfmodel/resync.py`` lower bound.
    fault_rates:
        Per-iteration fault probabilities lambda swept by the fault
        stage (they parameterize the geometric onset draw).
    fault_shard_counts:
        Mesh sizes P for the fault stage; the subprocess forces
        ``max(fault_shard_counts)`` host devices and smaller meshes use
        device subsets.  Must divide ``fault_n``.
    fault_n / fault_maxiter:
        Problem size and iteration cap of each fault-stage solve (the
        shifted tridiagonal Laplacian converges to ``fault_tol`` in a
        few dozen iterations).
    fault_checkpoint_period:
        Segment length / checkpoint period of the elastic controller,
        in iterations — the ``period`` of the resync overhead bound.
    fault_tol:
        Convergence tolerance of the fault-stage solves.
    fault_stall_s:
        Injected per-iteration stall of the ``stall`` fault kind, in
        seconds (must dominate the clean per-iteration time so the
        step-time detector sees a persistent outlier).
    serve_requests:
        Open-loop request count of the serve stage (0 disables the
        stage; the serve acceptance load is >= 64).  The stage runs
        the ``repro_torch.serve`` continuous batcher on a burst (throughput vs
        a k=1 sequential server), an accuracy sample (batched vs solo
        retired solutions), and a utilization-paced run validated
        against the M/G/k queueing perfmodel.
    serve_n / serve_tol / serve_maxiter:
        Problem size, convergence tolerance and iteration cap of each
        served solve (tridiagonal Laplacian family).
    serve_modes:
        ``(lo, hi)`` range of Laplacian eigenmodes per RHS — CG's
        service demand is about the excited Krylov dimension, so this is
        the workload's service-time distribution knob (uniform mode
        counts give the M/G/k model a non-degenerate service law).
    serve_k_slots / serve_step_block / serve_engine:
        Batch-slot count, iterations per batch step, and iteration
        engine of the continuous batcher.  The port's default is
        ``fused``: on the card that is the hand-written sweep kernel
        (one launch an iteration for all k columns), on the CPU its
        plain torch version.  (The JAX package defaults to ``naive``
        because its fused kernel runs in Pallas interpret mode on the
        CPU, where dispatch overhead dominates at serve sizes.)
    serve_arrival:
        Arrival process name (``poisson`` or any
        ``noise_sources.make_distribution`` name incl. ``trace:<ALG>``).
    serve_rho:
        Target per-slot utilization of the paced run; the arrival rate
        is ``rho * k_slots / E[service]`` with the service time measured
        from the burst run.
    serve_replay_requests:
        Horizon of the steady-state discrete-event replay the M/G/k
        model is gated against (the short wall-clock run is transient;
        the analytic law is steady-state, so the gate needs a long
        deterministic replay of the measured demand distribution).
    precision_policies:
        ``PrecisionPolicy`` preset names swept by the mixed-precision
        stage (empty tuple disables the stage).  The default grid spans
        the safe ladder (``fp32`` -> ``bf16`` storage -> ``bf16`` +
        int8 halo wire with error feedback) plus two demonstrators:
        int8 wire WITHOUT error feedback (quantization residual
        accumulates — ``degraded``: within the floor but measurably
        above the EF plateau) and int8 on the carried Gram psum
        (consumed once per iteration — corrupts alpha/beta directly;
        ``unsafe``).  Each cell runs a REAL multi-device shard_map
        solve and measures the TRUE residual ``|b - A x|/|b|`` against
        the storage-precision attainable-accuracy floor
        ``C_solver * eps_storage`` (the Cools et al. rounding-error
        bound, scaled by the storage eps and a per-solver amplification
        constant — ``precision_exec.FLOOR_FACTORS``).
    precision_solvers:
        Sharded solvers swept by the precision stage.  ``pipebicgstab``
        only sweeps {fp32, bf16}: p-CG's cells already pin the wire
        contract, and its two-SpMV recurrence amplifies storage
        rounding by an order of magnitude (same order at fp32 and bf16,
        so the bf16 cell saturates within its amplified floor).
    precision_n / precision_shards:
        Problem size and mesh size of each precision-stage solve.  The
        p-CG cells run a diagonally dominant pentadiagonal band with
        half-bandwidth 128 (wide enough that the int8 halo strips carry
        real payload and dropping error feedback is measurable); the
        p-BiCGStab cells a shifted tridiagonal Laplacian (see
        ``precision_exec._spd_tridiagonal``).
    precision_maxiter:
        Iteration cap of the pipecg precision cells (the solve runs to
        its attainable-accuracy plateau, not to a tolerance);
        pipebicgstab cells use 1.5x of it (past the saturation knee of
        the bf16 plateau).
    geometry_formats:
        Operator formats swept by the geometry stage (subset of
        {"dia", "bsr", "dia2d"}; empty tuple disables the stage).  Each
        cell runs a REAL multi-device ``sharded_fused`` solve in a
        forced-device subprocess (``geometry_exec.py``) and is gated on
        (a) matching the single-device reference to 1e-8, (b) exactly
        one all-reduce per compiled while body with the halo ppermutes
        independent of it (split-phase overlap), and (c) an XLA
        ppermute count equal to the surface-to-volume message model of
        ``core/perfmodel/comm.py`` (2 vectors x 2 messages per
        decomposed axis).
    geometry_grids:
        2-D process grids (py, px) swept by the ``dia2d`` cells; the
        sweep must include ``comm.best_grid``'s pick so the validation
        can check the model's minimizer against the swept set.
    geometry_shards:
        1-D shard count of the ``dia`` / ``bsr`` cells.
    geometry_points:
        Global lattice extents (ny, nx); the 1-D cells flatten to
        ``ny * nx`` rows.
    geometry_bs:
        BSR block size of the ``bsr`` cells.
    geometry_maxiter / geometry_tol / geometry_repeats:
        Iteration count (the scan always runs ``maxiter`` steps, so the
        per-iteration time is wall / maxiter), freeze tolerance, and
        timed repeats per cell.
    geometry_noise_scale:
        Seconds per unit draw of the wall-clock ``NoiseHook`` stall in
        each cell's noisy twin run (exponential waits; the noise axis
        of the format x grid x noise sweep).
    seed:
        Base seed; every stage derives its own stream from it.
    """

    name: str
    solvers: Tuple[str, ...] = ("pipecg", "pipecr", "pgmres",
                                "pipebicgstab")
    engines: Tuple[str, ...] = ("naive", "fused", "sharded_fused")
    noises: Tuple[str, ...] = ("uniform", "exponential", "lognormal",
                               "trace:PIPECG")
    shard_counts: Tuple[int, ...] = (2, 4, 8)
    trials: int = 96
    iters: int = 2000
    fit_samples: int = 2000
    exec_solvers: Tuple[str, ...] = ("cg", "pipecg", "bicgstab",
                                     "pipebicgstab")
    exec_n: int = 2048
    exec_maxiter: int = 25
    exec_repeats: int = 6
    exec_noise: str = "exponential"
    noise_scale: float = 1.5e-3
    depths: Tuple[int, ...] = (1, 2, 4)
    depth_shard_counts: Tuple[int, ...] = (4, 8)
    depth_red_latency: float = 2.0
    depth_exec_maxiter: int = 40
    sync_counts: Tuple[int, ...] = (2, 4)
    sync_shard_counts: Tuple[int, ...] = (4, 8)
    sync_red_latency: float = 2.0
    abft_solvers: Tuple[str, ...] = ("pipecg", "pipebicgstab", "pipecg_l")
    abft_magnitudes: Tuple[float, ...] = (1e-12, 1.0, 1e3)
    abft_n: int = 240
    abft_shards: int = 4
    abft_maxiter: int = 60
    abft_tol: float = 1e-10
    abft_depth: int = 2
    fault_kinds: Tuple[str, ...] = ("kill", "stall", "corrupt")
    fault_rates: Tuple[float, ...] = (0.05,)
    fault_shard_counts: Tuple[int, ...] = (4,)
    fault_n: int = 240
    fault_maxiter: int = 120
    fault_checkpoint_period: int = 10
    fault_tol: float = 1e-10
    fault_stall_s: float = 0.03
    serve_requests: int = 64
    serve_n: int = 256
    serve_modes: Tuple[int, int] = (32, 256)
    serve_tol: float = 1e-8
    serve_maxiter: int = 600
    serve_k_slots: int = 8
    serve_step_block: int = 8
    serve_engine: str = "fused"
    serve_arrival: str = "poisson"
    serve_rho: float = 0.7
    serve_replay_requests: int = 16384
    precision_policies: Tuple[str, ...] = ("fp32", "bf16", "bf16_int8wire",
                                           "bf16_int8wire_noef",
                                           "bf16_int8allwire")
    precision_solvers: Tuple[str, ...] = ("pipecg", "pipebicgstab")
    precision_n: int = 1024
    precision_shards: int = 4
    precision_maxiter: int = 300
    geometry_formats: Tuple[str, ...] = ("dia", "bsr", "dia2d")
    geometry_grids: Tuple[Tuple[int, int], ...] = ((4, 1), (2, 2), (1, 4))
    geometry_shards: int = 4
    geometry_points: Tuple[int, int] = (16, 16)
    geometry_bs: int = 4
    geometry_maxiter: int = 40
    geometry_tol: float = 1e-10
    geometry_repeats: int = 3
    geometry_noise_scale: float = 4e-3
    seed: int = 0


PRESETS: Dict[str, CampaignSpec] = {
    # CPU-friendly: completes in well under a minute, deterministic seed.
    "smoke": CampaignSpec(name="smoke"),
    # The paper's scales: P up to Piz Daint's 8192, 5000 forced iterates,
    # ex23-sized execution runs.  Minutes on one CPU.
    "paper": CampaignSpec(
        name="paper",
        shard_counts=(2, 4, 16, 64, 256, 1024, 8192),
        trials=96,
        iters=5000,
        # 2000 like smoke: the composite-GoF critical values (CvM /
        # Lilliefors with estimated parameters) are asymptotic
        # approximations whose alpha=0.05 calibration drifts by n=4000 —
        # the round-trip check then false-rejects on ~1-in-20 streams
        fit_samples=2000,
        exec_n=65536,
        exec_maxiter=60,
        exec_repeats=12,
        depth_shard_counts=(4, 64, 1024),
        depth_exec_maxiter=60,
        fault_rates=(0.02, 0.05, 0.1),
        fault_shard_counts=(4, 8),
        serve_requests=128,
    ),
}


def get_preset(name: str) -> CampaignSpec:
    """Look up a preset by name (raises with the known names otherwise)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]
