#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, with nothing else: it builds the CUDA
kernels from src/repro_torch/kernels/csrc/ and then, one line per step,

1. device: the card's name and ``nvidia-smi`` name + power limit;
2. build: compiles the kernel library (one nvcc per source, in parallel),
   prints each row-window and ghost-chain sweep, ``fused_dots`` and
   ``wkv_recurrent`` instantiation's registers, shared memory and spills
   (``-Xptxas -v``; a spill in the last two fails the run), and counts
   the tensor-core instructions (HMMA, HGMMA) in the SASS of the bf16
   flash kernel (``cuobjdump -sass``; none fails the run);
3. kernels: each CUDA kernel against its plain torch version at the main
   path's shapes (ex23's n = 2,097,152 tridiagonal, float64; the 5-band
   ``laplacian_2d(1448, 1448)``; k = 1 and 8; float32; float32 with bf16
   storage; the per-rank halo sweep at the 4-rank local size 524,288 with
   real neighbour strips and operator rows, and 4 such slices summed
   against the one-device sweep; ``fused_dots`` at m = 3, 2, 1, 30, 41 and 42,
   a second launch bit for bit), with its
   CUDA-event time (median of 25), the plain version's, the library
   call's where one computes the same function (``torch.sparse`` CSR mv,
   ``torch.mv``), and its bound.  The four row-window sweep entries (#2,
   #3, #8, #9) are held to their plain versions bit for bit, a second
   launch must repeat the first bit for bit, partials included, and each
   column of #2's k = 8 launches must equal a one-column launch;
   The p-BiCGStab sweep (#8) runs on the nonsymmetric
   ``convection_diffusion`` at the same n, on ``laplacian_2d(1448, 1448)``,
   in float32 and with bf16 chains and bands; its per-rank form (#9) on
   rank 1 of 4 slices, and 4 slices against the one-device sweep.
   The 21-band ``glen_law_band`` at the same n runs through #1, #2 and #8
   (ROADMAP.md H10).  #1's extended-x entry ``spmv_dia_ext`` on rank 1 of
   4's rows (n = 524,288) of ex23 (halo 1) and of glen (halo 10) with
   random strips, bit for bit, beside a ``torch.sparse`` CSR mv.  The
   ghost-chain sweep (#4) at l = 2 and 4 on ex23,
   l = 2 and 4 on ``laplacian_2d(1448, 1448)`` (the latter in the
   global-memory workspace), l = 4 on glen, in float32 and with bf16
   storage; its per-rank form (#5) on rank 1 of 4, and 4 slices against
   the one-device chain; a second launch of each must repeat the chain
   and the Gram bit for bit.  The BSR kernels (#10 ``spmv_bsr``, #11
   ``pipecg_bsr_fused``) on ``dia_to_bsr`` of ex23 and of
   ``laplacian_2d(1448, 1448)`` at bs 4 (ex23-bsr4, lap2d-bsr4; the
   conversion's host seconds printed), k = 1, ex23-bsr4 at k = 8 and in
   float32, ``spmv_bsr`` beside a ``torch.sparse`` mv of the same matrix
   (BSR layout where torch runs it for float64 on the card, else CSR).
   The BSR sweep also on lap2d-bsr4 under a random block permutation
   (most gathers leave a CTA's range of block rows), with the share of
   gathers that recompute u' printed for each operator.
   The LM kernels: ``flash_attention`` (#12) at the ``[serve]`` prefill's
   shape (64, 2048, 128) bf16 causal (on the tensor cores: the two-part
   bar of ``flash_attn.bf16_error`` against the float32 plain version),
   (3, 200, 64) f32 causal and (2, 256, 64) f32 non-causal (2e-5), timed
   beside
   ``scaled_dot_product_attention``; ``wkv_recurrent`` (#13) at rwkv6-7b's
   (256, 2048, 64) with f32 and bf16 inputs, random decays and logw = -8
   and -1e-4 (2e-5 of max |o|, finite, a second launch bit for bit);
4. main path: ``pipecg(engine="fused", maxiter=5000)`` on ex23 with the
   launch counts read around it, its history held against
   ``engine="naive"``, then Jacobi, ``pipecg_multi`` (k=8) against 8 single
   solves, ``pipecr``, and a callable-M solve on the update-kernel fallback;
   then ``[bicgstab]``: ``pipebicgstab(M="jacobi", engine="fused",
   maxiter=5000)`` on convection_diffusion with the counts set to 0 just
   before it and read just after it (5000 sweeps, no SpMV), its first 20
   residuals against ``engine="naive"``, the ``tol=1e-10`` solve's
   ``iters`` against naive's, classical ``bicgstab`` to the same tol and a
   callable M through the engine's SpMV;
   then ``[depth]``: ``pipecg_l(engine="fused", maxiter=5000)`` on ex23 at
   l = 2 and at l = 4, each with the counts set to 0 just before it and
   read just after it (2500 / 1250 chain sweeps, nothing else), its first
   200 residuals against ``engine="naive"`` and within the Cools bound
   1e-6 of depth-1 PIPECG, x's true residual against the recurrence's;
   ``pgmres_l(restart=40, l=2)`` through the SpMV kernel against naive;
   then ``[gmres]``: ``gmres`` and ``pgmres`` (restart 40) on ex23 through
   the fused engine, each with the counts set to 0 just before it and
   read just after it (40 ``fused_dots`` + 42 ``spmv_dia``; 42 + 44), ms
   per Arnoldi step, their histories against ``engine="naive"`` (H6),
   gmres vs pgmres x, ``gmres_restarted(cycles=2)`` with ``inner=pgmres``
   against ``inner=gmres``, and the progressive Givens recurrence timed
   alone;
   then ``[bsr]``: ``pipecg(engine="fused", maxiter=5000)`` on ex23-bsr4
   with the counts set to 0 just before it and read just after it (2
   ``spmv_bsr`` + 5000 ``pipecg_bsr_fused``, no DIA kernel), its first
   200 residuals against ``engine="naive"`` on the same BsrMatrix and
   against the DIA PIPECG on the ex23 operator it came from, x's true
   residual (``true_residual_norm``) against the recurrence's; then, each
   with its counts, Jacobi on lap2d-bsr4, ``pipecg_multi`` (k=8) against
   8 single solves, ``pipecr`` and a callable-M solve on the fallback
   (``pipecg_fused`` + one ``spmv_bsr`` per iteration);
5. ranks: ex23 on 4 ranks of one process group, all on this card
   (``distributed_solve(pipecg, engine="sharded_fused", maxiter=5000)``,
   gloo with host-staged strips on one card, NCCL with one card per
   rank), its launch counts, split-phase order and history held against
   the one-device fused solve; 200-iteration pipecr, Jacobi,
   ``pipecg_multi`` (k=4), inline ``cg``/``pipecg`` and a 2-rank solve
   against theirs; the same solve under injected Exponential noise, whose
   history must equal the quiet one bit for bit; the inline route with
   ``use_kernel=True`` (the extended-x SpMV on every rank) for ``gmres``
   and ``pgmres`` (restart 40) and ``pipecg``, against one device, its
   ``spmv_dia_ext`` launches counted and PGMRES's two all-reduces an
   iteration checked; p-BiCGStab on the same 4
   ranks (500 forced iterates with Jacobi, 4 x 500 halo sweeps, the H5
   order, no blocking all-reduce; the tol solve's ``iters`` and the first
   20 residuals against one device; the inline path with one all-reduce
   per iteration); ``pipecg_l`` at l = 2 on the same 4 ranks (2000
   iterates: 4 x 1000 chain sweeps, the depth order halo < launch < issue
   < wait per block, one all-reduce per block, the first 20 blocks against
   one device) and a tol solve on glen with Jacobi against one device;
   ex23-bsr4 through the plain-torch BSR body on the chain of 4 ranks and
   ``laplacian_2d(1448, 1448)`` on a (2, 2) grid of them, plain and
   Jacobi (500 forced iterates each: the H5 order and one all-reduce per
   iteration on every rank, the first 20 residuals against one device,
   host microseconds per iteration between the recorded events);
   then ``[wire]``: the int8 halo/Gram wire on the same 4 ranks, the JAX
   package's precision-stage problems (PIPECG on the pentadiagonal band
   with halo 128, 300 iterations; p-BiCGStab on the shifted tridiagonal,
   450) at n = 2,097,152 and at the stage's n = 1024, under the five
   policies fp32 / bf16 / bf16_int8wire / bf16_int8wire_noef /
   bf16_int8allwire: the split-phase order, the int8 bytes each rank
   hands ``comm``, the stage's classification of the PIPECG cells (in
   full at n = 1024; safe and unsafe at full size), finite p-BiCGStab
   results; the plateau in storage-eps units, host µs an iteration of
   halo / wait / launch / issue and the bytes a strip for each cell;
   then ``[resilient]``: ``resilient_distributed_solve`` on 4 ranks at
   n = 2,097,144 (tol 1e-10, a checkpoint every 10 iterations):
   undisturbed, kill:1@14, kill:1@14 + kill:3@26, corrupt:2@8,
   stall:0@5, stall:0@5 + corrupt:2@25 and kill:1@14 + kill:3@32, their
   recovery events and their overhead against 2x
   ``recovery_overhead_bound``, a checkpoint save of the handed-off
   device state timed as the loop makes it (host copy, background
   write), ``optimal_checkpoint_period`` at the copy's cost, and the
   carried hand-off from 4 ranks to 2 against the straight solve;
6. LM: ``[wkv]``, the ``ops.wkv_recurrent`` entry once at rwkv6-7b's
   shape with the counts set to 0 just before it and read just after it;
   ``[serve]``, ``launch.serve.serve`` of qwen3-1.7b at full width (28
   layers, d_model 2048, random weights from seed 0) with
   ``attn_kernel=True``, batch 4, prompt 2048, 32 greedy decode steps,
   after a 2-step warm-up, with the counts set to 0 just before it and
   read just after it (28 flash launches in prefill, none in decode):
   prefill ms, decode p50/p99 ms per token, peak memory; its prefill
   logits against the dense route's on the same weights and prompt and
   its second token against a prefill over prompt + first token, at the
   JAX package's bf16 bars (|diff| <= 0.15, argmax agreement >= 0.5);
   then ``[solve_serve]``: solver serving at ex23's n = 2,097,152 on the
   fused engine, ``run_serve_exec`` with the JAX package's serve workload
   (64 requests of 32-256 Laplacian modes, tol 1e-8, maxiter 600, k = 8
   slots, blocks of 8: burst batched against a k = 1 server, 4 requests
   solo against their batched records bit for bit, rho 0.7 paced
   arrivals and the M/G/k quantiles within 0.10 of the 16,384-request
   replay) and a ``SolverServer`` over 16 trace-paced requests under
   the reference's chaos lane, the counts set to 0 just before and read
   just after, each run's launches held to its blocks and admissions
   (one sweep an iteration, two SpMVs an admission); each request
   converged or reported not converged after maxiter (H14): requests/s,
   occupancy, p50/p99/p999, ms a block, restarts and detections;
7. model: ``asymptotic_speedup`` as in examples/quickstart.py, a
   ``simulate(Exponential(1), P=8192, K=200, trials=256)`` on the card,
   the s-sync model (``s_sync_speedup``, ``s_sync_ceiling``) and the depth
   model (``depth_speedup_table``, ``depth_speedup_ceiling``,
   ``crossover_depth``); the folk theorem (Eq. 5 on a staggered trace),
   Eq. 6/7 against ``simulate``'s per-step means at P = 8192,
   ``predict_speedup`` on ``ex23_models`` with the port's H100
   ``Hardware()`` at depth 1 and 2, the Table-1 fit rows from runs drawn
   on the card, and ``makespan_trace_large`` at P = 8192, K = 5000, timed;
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Every check raises: the script exits non-zero and prints no result when a
kernel does not build, does not launch or disagrees, when no CUDA device
is present, or when it is run outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# the device every phase runs on
DEVICE = "cuda"
# kernels of the one-device path (phase 4); the rank path's come in phase 5
ONE_DEVICE = ("spmv_dia", "pipecg_spmv_fused", "pipecg_fused")

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): memory 3.35 TB/s;
# float64 and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
N_EX23 = 2_097_152
MAXITER = 5000
CHECK_ITERS = 200
RANKS = 4
NOISE_SCALE = 1e-4   # seconds per unit draw: Exponential(1) waits, 100 us mean
# p-BiCGStab: forced iterates on 4 ranks, the inline path's, the history
# window held to rtol 1e-10 (ROADMAP.md queue 3, H6) and the tol solve's
BICG_RANK_ITERS = 500
BICG_INLINE_ITERS = 200
BICG_CHECK = 20
BICG_TOL = 1e-10
BICG_TOL_ITERS = 200
# ROADMAP.md queue 3, H8 (tests/test_torch_bicgstab.py::
# test_forced_iterates_drift_like_the_reference): forced iterates past
# convergence keep the recurrence residual at rounding level while x's
# true residual drifts to a few 1e-2 of ||b||, in the JAX reference too;
# a residual replacement every BICG_RR iterations pins x
BICG_REC_MAX = 1e-13   # recurrence residual / ||b|| after convergence
BICG_DRIFT_MAX = 0.1   # true residual / ||b|| of a forced x
BICG_RR = 50
# depth-l (pipecg_l): the depths driven on one device, the rank solve's
# forced iterates and the blocks its history is held to one device over,
# the tol solve on the 21-band glen operator; the Cools gate of
# tests/test_pipeline_depth.py (history within 1e-6 of depth-1 above 1e-8
# of its largest entry) and the forced x's true-vs-recurrence gap
DEPTHS = (2, 4)
DEPTH_RANK_ITERS = 2000
DEPTH_CHECK_BLOCKS = 20
DEPTH_TOL = 1e-10
DEPTH_TOL_ITERS = 200
COOLS_RTOL = 1e-6
COOLS_FLOOR = 1e-8
DEPTH_GAP_MAX = 1e-8
PGMRES_RESTART = 40
# GMRES / PGMRES (Algorithms 1 and 2) at the quickstart's restart length;
# gmres vs pgmres x and restarted inner=pgmres vs inner=gmres are held to
# the bar of tests/test_torch_gmres.py (the reference's
# test_pgmres_matches_gmres: rtol 1e-5, atol 1e-7)
GMRES_RESTART = 40
GMRES_RTOL, GMRES_ATOL = 1e-5, 1e-7
# the model: makespan_trace_large at Piz Daint scale (P = 8192, K = 5000)
TRACE_TRIALS = 32
# BSR and 2-D grids: the block size (the JAX package's default), the
# 2-D Laplacian's lattice edge (n = 2,096,704), the rank solves' forced
# iterates and the residuals held to one device
BSR_BS = 4
NX_LAP = 1448
GEOM_RANK_ITERS = 500
GEOM_CHECK = 20
GRID = (2, 2)
# LM serving (qwen3-1.7b at full width): the [serve] phase's batch, prompt
# and decode steps; the flash kernel's shape is that prefill's attention
# with KV repeated to 16 heads; the wkv kernel's is rwkv6-7b's 64 heads of
# 64 at batch 4, T 2048.  Bars: flash against its plain version in
# float32, f32 inputs 2e-5, bf16 inputs the two-part bar of
# flash_attn.bf16_error (P is rounded to bf16 on the tensor cores); wkv
# 2e-5 of max |o|; the kernel-vs-dense prefill logits at the JAX
# package's bf16 bars (tests/test_models_smoke.py)
# the int8 wire ([wire]): the JAX package's precision stage's problems
# (experiments/precision_exec.py: the pentadiagonal band with halo 128 and
# a Gaussian b for PIPECG, 300 iterations; the shifted tridiagonal with
# b = ones for p-BiCGStab, 450) at full size and at the stage's own n =
# 1024, under its five policies; its floors (FLOOR_FACTORS x storage eps)
# and its no-EF / EF ratio (1.05)
WIRE_N = 2_097_152
WIRE_STAGE_N = 1024
WIRE_ITERS = {"pipecg": 300, "pipebicgstab": 450}
WIRE_POLICIES = ("fp32", "bf16", "bf16_int8wire", "bf16_int8wire_noef",
                 "bf16_int8allwire")
WIRE_FLOOR = {"pipecg": 2.0, "pipebicgstab": 32.0}
WIRE_NOEF_RATIO = 1.05
# elastic recovery ([resilient]): tests/test_elastic.py's shifted
# tridiagonal Laplacian at n = 24 x 87,381 (the 2^21 of the paper does not
# split over 3 survivors), tol 1e-10, checkpoints every 10 iterations; the
# measured overhead within 2x the resync bound (experiments/validation.py)
RES_N = 2_097_144
RES_PERIOD = 10
RES_TOL = 1e-10
RES_OVERHEAD_FACTOR = 2.0
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_STEPS = 32
FLASH_SHAPE = (64, 2048, 128)
WKV_SHAPE = (256, 2048, 64)
FLASH_F32_TOL = 2e-5
WKV_REL_TOL = 2e-5
LOGIT_TOL = 0.15
ARGMAX_AGREE = 0.5
# solver serving ([solve_serve]): the JAX package's serve workload (its
# CampaignSpec defaults: 64 requests of 32-256 Laplacian modes, tol 1e-8,
# maxiter 600, k = 8 slots, blocks of 8, rho 0.7, a 16,384-request
# replay) at ex23's n on the fused engine; the chaos lane of the
# reference's tests/test_serve.py on 16 trace-paced requests; the model's
# p50/p99 within the stage's 0.10 of the replay
SOLVE_SERVE_CHAOS = ("kill:1@3", "stall:0@6", "kill:2@9", "corrupt:3@5")
SOLVE_SERVE_CHAOS_REQUESTS = 16
SOLVE_SERVE_MODEL_TOL = 0.10
SOLVE_SERVE_TIMED_BLOCKS = 10
# the requests of the seed-0 workload that stop at maxiter 600 at this n
# (ROADMAP H14), by run; each is held to the naive engine's true residual
# at the same maxiter
SOLVE_SERVE_CAPPED = {"burst batched": [2, 12], "burst sequential": [2, 12],
                      "paced": [32], "chaos": [4]}


# the row-window sweeps (#2, #3, #8, #9), the ghost-chain sweep (#4, #5),
# fused_dots (#7) and wkv (#13), whose ptxas usage [build] prints; the
# last two must not spill
SWEEP_KERNELS = ("pipecg_sweep_kernel", "pipebicgstab_sweep_kernel",
                 "ghost_chain_kernel", "fused_dots_kernel", "wkv_kernel")
NO_SPILL_KERNELS = ("fused_dots_kernel", "wkv_kernel")


class SmokeFailure(RuntimeError):
    """A phase found a fault."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes/HBM rate, flops/peak."""
    import torch
    key = {torch.float64: "float64",
           torch.bfloat16: "bfloat16"}.get(dtype, "float32")
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[key] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls.

    Each sample first queues a spin kernel (``torch.cuda._sleep``) so the
    host has enqueued the call before the card reaches it: the events then
    bracket device time only, not Python's launch overhead.
    """
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def repeats(name, fn, args, first) -> None:
    """A second launch equals ``first`` bit for bit, partials included."""
    import torch
    again = fn(*args)
    for i, (g, a) in enumerate(zip(first, again)):
        check(torch.equal(g, a), f"{name} out{i} differs between launches")


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def hist_close(ref, got, rtol=1e-10, floor_rel=1e-10) -> float:
    """Largest relative gap above the floor (the reference's _hist_close)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    check(ref.shape == got.shape, f"history shapes {ref.shape} {got.shape}")
    mask = ref > floor_rel * max(float(ref.max()), 1.0)
    check(int(mask.sum()) > 0, "history entirely below the floor")
    gap = float(((got[mask] - ref[mask]).abs() / ref[mask]).max())
    check(gap <= rtol, f"histories differ by {gap:.3e} > {rtol}")
    return gap


def csr_of(A):
    """``torch.sparse`` CSR copy of a DIA operator (the library yardstick)."""
    import torch
    rows, cols, vals = [], [], []
    i = torch.arange(A.n, device=A.device)
    for k, off in enumerate(A.offsets):
        keep = (i + off >= 0) & (i + off < A.n)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(A.bands[k][keep])
    with warnings.catch_warnings():  # torch.sparse's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]),
            torch.cat(vals), (A.n, A.n))
        return coo.coalesce().to_sparse_csr()


def prepare() -> str:
    """Make the checkout's port importable; '' or why it cannot run here."""
    try:
        import torch
    except ImportError:
        return "torch is not installed"
    if not torch.cuda.is_available():
        return "no CUDA device; this script runs on the card"
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return "run from the root of a checkout (src/repro_torch is missing)"
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ""


def card():
    """The card's name and nvidia-smi's 'name, power.limit' line."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return torch.cuda.get_device_name(0), smi.stdout.strip().splitlines()[0]


def ex23(gen):
    """The paper's problem on the card: tridiag(-1, 2, -1) at n = 2^21
    and a float64 right-hand side drawn from ``gen``."""
    import torch
    from repro_torch.core.krylov import tridiagonal_laplacian
    b = torch.randn(N_EX23, generator=gen, device=gen.device,
                    dtype=torch.float64)
    return tridiagonal_laplacian(N_EX23, device=gen.device), b


def phase_device():
    import torch
    name, line = card()
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(line, flush=True)
    return name, line


def phase_build():
    from repro_torch.kernels import build
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    so, log = build.build()
    build.lib()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", compiled=fresh,
        library=so.name)
    if not log:
        say("build", ptxas="not measured (library built before this run)")
    for fn, use in build.ptxas_usage(log, SWEEP_KERNELS).items():
        say("build", ptxas=fn, **use)
        if any(k in fn for k in NO_SPILL_KERNELS):
            check(use.get("spill_stores", 0) == 0
                  and use.get("spill_loads", 0) == 0, f"{fn} spills")
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        say("build", sass="not measured (no cuobjdump beside nvcc)")
        return
    for fn, ops in flash_sass_counts(tool, so).items():
        say("build", sass=fn, **ops)
        if "tc_kernel" in fn:
            check(ops["HMMA"] + ops["HGMMA"] > 0,
                  f"no tensor-core instruction in {fn}")


def flash_sass_counts(tool, so) -> dict:
    """{kernel: {"HMMA": n, "HGMMA": n, "FFMA": n}} over the SASS of the
    library's flash kernels (``cuobjdump -sass``)."""
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = name if "rt" in name and "flash_" in name else None
            if fn:
                counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif fn:
            for op in counts[fn]:
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    check(bool(counts), f"no flash kernel in the SASS of {so.name}")
    return counts


def phase_kernels():
    """Each kernel against its plain version; returns the JSON records."""
    import torch
    from repro_torch.core.krylov import (convection_diffusion, glen_law_band,
                                         laplacian_2d, tridiagonal_laplacian)
    from repro_torch.kernels.checksum import dia_column_checksum
    from repro_torch.kernels.pipecg_fused import (pipecg_fused,
                                                  pipecg_fused_plain)
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_fused, pipecg_spmv_fused_plain)
    from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_plain

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    tri = tridiagonal_laplacian(N_EX23, device=dev)
    lap = laplacian_2d(1448, 1448, device=dev)
    records = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=f64).to(dt)

    # -- #1 spmv_dia -------------------------------------------------------
    for A, label in ((tri, "tridiag"), (lap, "lap2d")):
        x = randn((A.n,), f64)
        y = spmv_dia(A.offsets, A.bands, x)
        want = spmv_dia_plain(A.offsets, A.bands, x)
        torch.cuda.synchronize()
        err = max_err([y], [want])
        scale = float(want.abs().max())
        check(err <= 1e-12 * scale, f"spmv_dia {label}: err {err}")
        ms = time_ms(lambda: spmv_dia(A.offsets, A.bands, x))
        plain_ms = time_ms(lambda: spmv_dia_plain(A.offsets, A.bands, x))
        b_ms, b_by = bound(nbytes(A.bands, x, y), 2.0 * len(A.offsets) * A.n,
                           x.dtype)
        lib_ms = None
        if label == "tridiag":
            csr = csr_of(A)
            lib_ms = time_ms(lambda: torch.mv(csr, x))
            check(max_err([torch.mv(csr, x)], [want]) <= 1e-12 * scale,
                  "CSR yardstick disagrees")
            records["spmv_dia"] = dict(
                name="spmv_dia", route="cuda",
                source="src/repro_torch/kernels/csrc/spmv_dia.cu",
                replaces="src/repro/kernels/spmv_dia.py:34",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        say("kernel", name="spmv_dia", shape=label, n=A.n, dtype="float64",
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            library_ms=f"{lib_ms:.4f}" if lib_ms else None)

    # -- #2 pipecg_spmv_fused -------------------------------------------------
    cases = [(tri, "tridiag", 1, f64, f64), (tri, "tridiag", 8, f64, f64),
             (tri, "tridiag", 1, f32, f32), (tri, "tridiag", 1, f32, bf16),
             (lap, "lap2d", 1, f64, f64), (lap, "lap2d", 8, f32, bf16)]
    for A, label, k, acc, sto in cases:
        n = A.n
        x = randn((k, n), acc)
        r, u, p = (randn((k, n), sto) for _ in range(3))
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        bands = A.bands.to(sto)
        invd = (1.0 / A.diagonal()).to(sto)
        csum = dia_column_checksum(A.offsets, bands)
        args = (A.offsets, bands, invd, csum, x, r, u, p, a, b)
        got = pipecg_spmv_fused(*args)
        want = pipecg_spmv_fused_plain(*args)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got[:4], want[:4])):
            check(torch.equal(g, w), f"pipecg_spmv_fused {label} out{i} "
                  f"differs from the plain version")
        repeats(f"pipecg_spmv_fused {label}", pipecg_spmv_fused, args, got)
        if k > 1:  # column j of the k-column launch == a one-column launch
            for j in range(k):
                one = pipecg_spmv_fused(*args[:4],
                                        *(t[j:j + 1] for t in args[4:]))
                for i, (g, w) in enumerate(zip(one, got)):
                    check(torch.equal(g[0], w[j]),
                          f"pipecg_spmv_fused {label} column {j} out{i} "
                          f"depends on k")
        # partials: the sums run in another order than torch.sum, so each
        # is held relative to the sum of its terms' magnitudes
        u2, r2 = want[2].to(acc), want[1].to(acc)
        w2 = spmv_dia_plain(A.offsets, bands.to(acc), u2)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (csum.to(acc) * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        red_tol = 1e-3 if sto == bf16 else {f64: 1e-10, f32: 1e-5}[acc]
        check(rel <= red_tol, f"partials {label}: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_spmv_fused(*args))
        plain_ms = time_ms(lambda: pipecg_spmv_fused_plain(*args))
        flops = k * n * (4 * len(A.offsets) + 22)
        b_ms, b_by = bound(nbytes(bands, invd, csum, x, r, u, p, a, b,
                                  *got), flops, acc)
        say("kernel", name="pipecg_spmv_fused", shape=label, k=k,
            accum=str(acc)[6:], storage=str(sto)[6:],
            max_abs_err=f"{err:.3e}", partial_rel=f"{rel:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}")
        if (label, k, acc, sto) == ("tridiag", 1, f64, f64):
            records["pipecg_spmv_fused"] = dict(
                name="pipecg_spmv_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_spmv_fused.cu",
                replaces="src/repro/kernels/pipecg_spmv_fused.py:223",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # -- #6 pipecg_fused -----------------------------------------------------
    for k, acc in ((1, f64), (8, f64), (1, f32)):
        vecs = [randn((k, N_EX23), acc) for _ in range(10)]
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        got = pipecg_fused(*vecs, a, b)
        want = pipecg_fused_plain(*vecs, a, b)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got[:8], want[:8])):
            check(torch.equal(g, w), f"pipecg_fused out{i} differs")
        r2, u2, w2 = want[1], want[2], want[3]
        mags = torch.stack([t.abs().sum(-1) for t in (r2 * u2, w2 * u2,
                                                       r2 * r2)], -1)
        rel = float(((got[8] - want[8]).abs() / mags).max())
        check(rel <= {f64: 1e-10, f32: 1e-5}[acc], f"pipecg_fused dots {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_fused(*vecs, a, b))
        plain_ms = time_ms(lambda: pipecg_fused_plain(*vecs, a, b))
        b_ms, b_by = bound(nbytes(*vecs, a, b, *got), 22.0 * k * N_EX23, acc)
        say("kernel", name="pipecg_fused", n=N_EX23, k=k, accum=str(acc)[6:],
            max_abs_err=f"{err:.3e}", dots_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}")
        if (k, acc) == (1, f64):
            records["pipecg_fused"] = dict(
                name="pipecg_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_fused.cu",
                replaces="src/repro/kernels/pipecg_fused.py:63",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    halo_kernel(records, gen, tri, lap)
    halo_slices_sum_to_sweep(gen, tri)
    dots_kernel(records, gen)
    cdf = convection_diffusion(N_EX23, device=dev)
    bicg_kernel(records, gen, cdf, lap)
    bicg_halo_kernel(records, gen, cdf)
    bicg_slices_sum_to_sweep(gen, cdf)
    glen = glen_law_band(N_EX23, device=dev)
    dia_ext_kernel(records, gen, tri, glen)
    glen_sweeps(gen, glen)
    chain_kernel(records, gen, tri, lap, glen)
    chain_halo_kernel(records, gen, tri)
    bsr_kernels(records, gen, tri, lap)
    lm_kernels(records, gen)
    return records


def dia_ext_kernel(records, gen, tri, glen):
    """#1's extended-x entry (``spmv_dia_ext``) against its plain version
    bit for bit on rank 1 of 4's rows of ex23 (halo 1) and of the 21-band
    glen operator (halo 10), with random neighbour strips; timed beside a
    ``torch.sparse`` CSR mv of the same (n, n + 2 halo) rows."""
    import torch
    from repro_torch.kernels.spmv_dia import spmv_dia_ext, spmv_dia_ext_plain
    n = N_EX23 // RANKS
    for A, label in ((tri, "tridiag"), (glen, "glen")):
        halo = max(abs(o) for o in A.offsets)
        bands = A.bands[:, n:2 * n].contiguous()
        x_ext = torch.randn(n + 2 * halo, generator=gen, device=gen.device,
                            dtype=torch.float64)
        y = spmv_dia_ext(A.offsets, bands, x_ext, halo)
        want = spmv_dia_ext_plain(A.offsets, bands, x_ext, halo)
        torch.cuda.synchronize()
        check(torch.equal(y, want), f"spmv_dia_ext {label} differs from the "
              "plain version")
        rows, cols, vals = [], [], []
        i = torch.arange(n, device=gen.device)
        for k, off in enumerate(A.offsets):
            rows.append(i)
            cols.append(i + halo + off)
            vals.append(bands[k])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_coo_tensor(
                torch.stack([torch.cat(rows), torch.cat(cols)]),
                torch.cat(vals), (n, n + 2 * halo)).coalesce() \
                .to_sparse_csr()
        scale = float(want.abs().max())
        check(max_err([torch.mv(csr, x_ext)], [want]) <= 1e-12 * scale,
              "CSR yardstick disagrees")
        ms = time_ms(lambda: spmv_dia_ext(A.offsets, bands, x_ext, halo))
        plain_ms = time_ms(lambda: spmv_dia_ext_plain(A.offsets, bands,
                                                      x_ext, halo))
        lib_ms = time_ms(lambda: torch.mv(csr, x_ext))
        b_ms, b_by = bound(nbytes(bands, x_ext, y),
                           2.0 * len(A.offsets) * n, x_ext.dtype)
        say("kernel", name="spmv_dia_ext", shape=label, n_local=n, halo=halo,
            bands=len(A.offsets), dtype="float64", max_abs_err=0.0,
            match="bit-equal", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", library_ms=f"{lib_ms:.4f}")
        if label == "tridiag":
            records["spmv_dia_ext"] = dict(
                name="spmv_dia_ext", route="cuda",
                source="src/repro_torch/kernels/csrc/spmv_dia.cu",
                replaces="src/repro/kernels/spmv_dia.py:34",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def rank_operands(A, P, q, x, r, u, p, sto):
    """Rank q of P's sweep operands cut from global (k, n) vectors: the
    operator rows [lo - h, hi + h) and the u/p strips [lo - 2h, lo) and
    [hi, hi + 2h), zero beyond the matrix, as the halo exchange gives them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.checksum import dia_column_checksum
    h, n = A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    bands = F.pad(A.bands, (h, h))[:, lo:hi + 2 * h]
    invd = F.pad(1.0 / A.diagonal(), (h, h))[lo:hi + 2 * h]
    csum = dia_column_checksum(A.offsets, bands, halo=h)
    wide = [F.pad(v, (2 * h, 2 * h)) for v in (u, p)]
    strips = []
    for v in wide:
        strips += [v[:, lo:lo + 2 * h], v[:, hi + 2 * h:hi + 4 * h]]
    cut = [v[:, lo:hi] for v in (x, r, u, p)]
    ops_ = [bands.to(sto), invd.to(sto), csum.to(sto), cut[0],
            *(v.to(sto) for v in cut[1:]), *(s.to(sto) for s in strips)]
    return [t.contiguous() for t in ops_], slice(lo, hi)


def halo_kernel(records, gen, tri, lap):
    """#3: the per-rank sweep on an interior rank (real strips, real
    neighbour operator rows) against its plain version."""
    import torch
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_halo, pipecg_spmv_halo_plain)
    from repro_torch.kernels.spmv_dia import spmv_dia_plain
    dev = tri.device
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    cases = [(tri, "tridiag", RANKS, 1, f64, f64),
             (tri, "tridiag", RANKS, 8, f64, f64),
             (tri, "tridiag", 1, 1, f64, f64),
             (tri, "tridiag", 1, 8, f64, f64),
             (tri, "tridiag", RANKS, 1, f32, bf16),
             (lap, "lap2d", RANKS, 1, f64, f64)]
    for A, label, P, k, acc, sto in cases:
        x, r, u, p = (torch.randn((k, A.n), generator=gen, device=dev,
                                  dtype=f64).to(acc) for _ in range(4))
        a = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        b = torch.rand(k, generator=gen, device=dev, dtype=f64).to(acc)
        q = min(1, P - 1)
        opnds, _ = rank_operands(A, P, q, x, r, u, p, sto)
        args = (A.offsets, *opnds, a, b)
        got = pipecg_spmv_halo(*args)
        want = pipecg_spmv_halo_plain(*args)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got[:4], want[:4])):
            check(torch.equal(g, w), f"pipecg_spmv_halo {label} out{i} "
                  f"differs from the plain version")
        repeats(f"pipecg_spmv_halo {label}", pipecg_spmv_halo, args, got)
        # the partials against the sum of their terms' magnitudes, the
        # terms taken over the rank's rows from the plain version's vectors
        h = A.halo
        r2, u2 = want[1].to(acc), want[2].to(acc)
        u_ext = torch.cat([torch.zeros((k, h), dtype=acc, device=dev), u2,
                           torch.zeros((k, h), dtype=acc, device=dev)], -1)
        w2 = spmv_dia_plain(A.offsets, opnds[0].to(acc), u_ext)[:, h:-h]
        c = opnds[2].to(acc)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (c * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        red_tol = 1e-3 if sto == bf16 else {f64: 1e-10, f32: 1e-5}[acc]
        check(rel <= red_tol, f"halo partials {label}: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_spmv_halo(*args))
        plain_ms = time_ms(lambda: pipecg_spmv_halo_plain(*args))
        n = x.shape[-1] // P
        flops = k * n * (4 * len(A.offsets) + 22)
        b_ms, b_by = bound(nbytes(*opnds, a, b, *got), flops, acc)
        say("kernel", name="pipecg_spmv_halo", shape=label, ranks=P,
            n_local=n, h=h, k=k, accum=str(acc)[6:], storage=str(sto)[6:],
            max_abs_err=f"{err:.3e}", partial_rel=f"{rel:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}")
        if (label, P, k, acc) == ("tridiag", RANKS, 1, f64):
            records["pipecg_spmv_halo"] = dict(
                name="pipecg_spmv_halo", route="cuda",
                source="src/repro_torch/kernels/csrc/pipecg_spmv_fused.cu",
                replaces="src/repro/kernels/pipecg_spmv_fused.py:252",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def halo_slices_sum_to_sweep(gen, A):
    """4 ranks' sweeps on slices of one global state: their vectors equal
    the one-device sweep's rows bit for bit, their partials sum to its row."""
    import torch
    from repro_torch.kernels.pipecg_spmv_fused import (pipecg_spmv_fused,
                                                       pipecg_spmv_halo)
    dev, f64 = A.device, torch.float64
    x, r, u, p = (torch.randn((1, A.n), generator=gen, device=dev,
                              dtype=f64) for _ in range(4))
    a = torch.rand(1, generator=gen, device=dev, dtype=f64)
    b = torch.rand(1, generator=gen, device=dev, dtype=f64)
    invd = (1.0 / A.diagonal()).contiguous()
    whole = pipecg_spmv_fused(A.offsets, A.bands, invd, A.column_checksum(),
                              x, r, u, p, a, b)
    total = torch.zeros_like(whole[4])
    for q in range(RANKS):
        opnds, rows = rank_operands(A, RANKS, q, x, r, u, p, f64)
        got = pipecg_spmv_halo(A.offsets, *opnds, a, b)
        for i, (g, w) in enumerate(zip(got[:4], whole[:4])):
            check(torch.equal(g, w[:, rows]), f"rank {q} out{i} differs")
        total = total + got[4]
    torch.cuda.synchronize()
    rel = float(((total - whole[4]).abs()
                 / whole[4].abs().clamp(min=1.0)).max())
    check(rel <= 1e-10, f"rank partials sum off by {rel}")
    say("kernel", check="4 rank slices == one-device sweep", n=A.n,
        vectors="bit-equal", partials_rel=f"{rel:.3e}")


def dots_kernel(records, gen):
    """#7: fused_dots against its plain version and torch.mv, at the rank
    init's m = 3, 2, 1 (n = 524,288) and the GMRES widths m = 30, 41
    (GMRES's m + 1 at restart 40) and 42 (PGMRES's m + 2) at n =
    2,097,152; a second launch repeats the first bit for bit."""
    import torch
    from repro_torch.kernels.fused_dots import fused_dots, fused_dots_plain
    dev, f64 = gen.device, torch.float64
    for m, n in ((3, N_EX23 // RANKS), (2, N_EX23 // RANKS),
                 (1, N_EX23 // RANKS), (30, N_EX23),
                 (GMRES_RESTART + 1, N_EX23), (GMRES_RESTART + 2, N_EX23)):
        V = torch.randn((m, n), generator=gen, device=dev, dtype=f64)
        z = torch.randn(n, generator=gen, device=dev, dtype=f64)
        got = fused_dots(V, z)
        want = fused_dots_plain(V, z)
        lib = torch.mv(V, z)
        torch.cuda.synchronize()
        mags = (V * z).abs().sum(-1)
        rel = float(((got - want).abs() / mags).max())
        check(rel <= 1e-12, f"fused_dots m={m}: {rel}")
        check(float(((lib - want).abs() / mags).max()) <= 1e-12,
              "torch.mv yardstick disagrees")
        repeats(f"fused_dots m={m}", lambda *a: (fused_dots(*a),), (V, z),
                [got])
        err = max_err([got], [want])
        ms = time_ms(lambda: fused_dots(V, z))
        plain_ms = time_ms(lambda: fused_dots_plain(V, z))
        lib_ms = time_ms(lambda: torch.mv(V, z))
        b_ms, b_by = bound(nbytes(V, z, got), 2.0 * m * n, f64)
        say("kernel", name="fused_dots", m=m, n=n, dtype="float64",
            max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}", repeat="bit-equal",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{lib_ms:.4f}", bound_ms=f"{b_ms:.4f}")
        if m == 3:
            records["fused_dots"] = dict(
                name="fused_dots", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_dots.cu",
                replaces="src/repro/kernels/fused_dots.py:32",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def bicg_operands(gen, A, acc, sto):
    """Random p-BiCGStab sweep operands on A's rows: x at the accumulator
    dtype, the seven chains (r, w, t, pa, a, c, r_hat) and the bands at
    the storage dtype, c = A^T 1 and alpha/beta/omega at the accumulator."""
    import torch
    from repro_torch.kernels.checksum import dia_column_checksum
    dev, f64 = A.device, torch.float64
    x = torch.randn(A.n, generator=gen, device=dev, dtype=f64).to(acc)
    chains = [torch.randn(A.n, generator=gen, device=dev, dtype=f64).to(sto)
              for _ in range(7)]
    sc = [torch.rand((), generator=gen, device=dev, dtype=f64).to(acc)
          for _ in range(3)]
    csum = dia_column_checksum(A.offsets, A.bands).to(acc)
    return A.bands.to(sto).contiguous(), csum, x, chains, sc


def gram_rel(got, want, C, csum) -> float:
    """Largest (7, 6) payload gap relative to the sum of its terms'
    magnitudes (the Gram of C and the checksum entry)."""
    import torch
    mags = C.abs() @ C.abs().T
    mags = torch.cat([mags, torch.zeros_like(mags[:1])])
    mags[6, 0] = C[2].abs().sum() + (csum * C[1]).abs().sum()
    gap = (got - want).abs()
    check(bool((gap[mags == 0] == 0).all()), "payload's zero entries moved")
    return float((gap / mags.clamp(min=torch.finfo(mags.dtype).tiny)).max())


def chains_equal(name, got, want) -> None:
    """The seven output vectors: bit for bit, bf16 ones too."""
    import torch
    for i, (g, w) in enumerate(zip(got[:7], want[:7])):
        check(torch.equal(g, w), f"{name} out{i} differs")


def bicg_bound(A, n, tensors, acc):
    """(bound_ms, bound_by) of one sweep over n rows moving ``tensors``:
    per row 9 updates, 2 band products, the 21-entry Gram and the
    checksum (4 n_bands + 75 flops)."""
    return bound(nbytes(*tensors), n * (4.0 * len(A.offsets) + 75), acc)


def bicg_kernel(records, gen, cdf, lap):
    """#8: the one-device p-BiCGStab sweep against its plain version."""
    import torch
    from repro_torch.kernels.pipebicgstab_fused import (
        pipebicgstab_fused, pipebicgstab_fused_plain)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    cases = [(cdf, "convdiff", f64, f64), (lap, "lap2d", f64, f64),
             (cdf, "convdiff", f32, f32), (cdf, "convdiff", f32, bf16)]
    for A, label, acc, sto in cases:
        bands, csum, x, chains, sc = bicg_operands(gen, A, acc, sto)
        args = (A.offsets, bands, csum, x, *chains, *sc)
        got = pipebicgstab_fused(*args)
        want = pipebicgstab_fused_plain(*args)
        torch.cuda.synchronize()
        chains_equal(f"pipebicgstab_fused {label}", got, want)
        repeats(f"pipebicgstab_fused {label}", pipebicgstab_fused, args, got)
        C = torch.stack([want[i].to(acc) for i in (1, 2, 3, 5, 6)]
                        + [chains[6].to(acc)])
        rel = gram_rel(got[7], want[7], C, csum)
        check(rel <= {f64: 1e-10, f32: 1e-5}[acc],
              f"pipebicgstab_fused {label} payload: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipebicgstab_fused(*args))
        plain_ms = time_ms(lambda: pipebicgstab_fused_plain(*args))
        b_ms, b_by = bicg_bound(A, A.n, (bands, csum, x, *chains, *sc,
                                         *got), acc)
        say("kernel", name="pipebicgstab_fused", shape=label, n=A.n,
            accum=str(acc)[6:], storage=str(sto)[6:],
            max_abs_err=f"{err:.3e}", gram_rel=f"{rel:.3e}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", share=f"{b_ms / ms:.3f}")
        if (label, acc, sto) == ("convdiff", f64, f64):
            records["pipebicgstab_fused"] = dict(
                name="pipebicgstab_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/pipebicgstab_fused.cu",
                replaces="src/repro/kernels/pipebicgstab_fused.py:213",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def bicg_rank_operands(A, P, q, x, chains):
    """Rank q of P's p-BiCGStab operands cut from global vectors: the
    operator rows [lo - h, hi + h), this rank's slice of c = A^T 1 and the
    w/t/c strips [lo - 2h, lo) and [hi, hi + 2h), zero beyond the matrix,
    as the exchanges give them."""
    import torch.nn.functional as F
    from repro_torch.kernels.checksum import dia_column_checksum
    h, n = A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    bands = F.pad(A.bands, (h, h))[:, lo:hi + 2 * h]
    csum = dia_column_checksum(A.offsets, bands, halo=h).to(x.dtype)
    strips = []
    for v in (chains[1], chains[2], chains[5]):          # w, t, c
        wide = F.pad(v, (2 * h, 2 * h))
        strips += [wide[lo:lo + 2 * h], wide[hi + 2 * h:hi + 4 * h]]
    sto = chains[0].dtype
    ops_ = [bands.to(sto), csum, x[lo:hi], *(v[lo:hi] for v in chains),
            *strips]
    return [t.contiguous() for t in ops_], slice(lo, hi)


def bicg_halo_kernel(records, gen, cdf):
    """#9: the per-rank p-BiCGStab sweep on rank 1 of 4 (real strips and
    neighbour operator rows) against its plain version."""
    import torch
    from repro_torch.kernels.pipebicgstab_fused import (
        pipebicgstab_halo, pipebicgstab_halo_plain)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    for acc, sto in ((f64, f64), (f32, bf16)):
        _, _, x, chains, sc = bicg_operands(gen, cdf, acc, sto)
        opnds, _ = bicg_rank_operands(cdf, RANKS, 1, x, chains)
        args = (cdf.offsets, *opnds, *sc)
        got = pipebicgstab_halo(*args)
        want = pipebicgstab_halo_plain(*args)
        torch.cuda.synchronize()
        chains_equal("pipebicgstab_halo", got, want)
        repeats("pipebicgstab_halo", pipebicgstab_halo, args, got)
        C = torch.stack([want[i].to(acc) for i in (1, 2, 3, 5, 6)]
                        + [opnds[9].to(acc)])       # r_hat
        rel = gram_rel(got[7], want[7], C, opnds[1])
        check(rel <= {f64: 1e-10, f32: 1e-5}[acc],
              f"pipebicgstab_halo payload: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipebicgstab_halo(*args))
        plain_ms = time_ms(lambda: pipebicgstab_halo_plain(*args))
        n = cdf.n // RANKS
        b_ms, b_by = bicg_bound(cdf, n, (*opnds, *sc, *got), acc)
        say("kernel", name="pipebicgstab_halo", shape="convdiff",
            ranks=RANKS, n_local=n, accum=str(acc)[6:],
            storage=str(sto)[6:], max_abs_err=f"{err:.3e}",
            gram_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            share=f"{b_ms / ms:.3f}")
        if acc == f64:
            records["pipebicgstab_halo"] = dict(
                name="pipebicgstab_halo", route="cuda",
                source="src/repro_torch/kernels/csrc/pipebicgstab_fused.cu",
                replaces="src/repro/kernels/pipebicgstab_fused.py:238",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def bicg_slices_sum_to_sweep(gen, A):
    """4 ranks' p-BiCGStab sweeps on slices of one global state: their
    vectors equal the one-device sweep's rows bit for bit, their partial
    payloads sum to its payload."""
    import torch
    from repro_torch.kernels.pipebicgstab_fused import (pipebicgstab_fused,
                                                        pipebicgstab_halo)
    f64 = torch.float64
    bands, csum, x, chains, sc = bicg_operands(gen, A, f64, f64)
    whole = pipebicgstab_fused(A.offsets, bands, csum, x, *chains, *sc)
    total = torch.zeros_like(whole[7])
    for q in range(RANKS):
        opnds, rows = bicg_rank_operands(A, RANKS, q, x, chains)
        got = pipebicgstab_halo(A.offsets, *opnds, *sc)
        for i, (g, w) in enumerate(zip(got[:7], whole[:7])):
            check(torch.equal(g, w[rows]), f"bicg rank {q} out{i} differs")
        total = total + got[7]
    torch.cuda.synchronize()
    C = torch.stack([whole[i] for i in (1, 2, 3, 5, 6)] + [chains[6]])
    rel = gram_rel(total, whole[7], C, csum)
    check(rel <= 1e-10, f"rank payloads sum off by {rel}")
    say("kernel", check="4 rank slices == one-device p-BiCGStab sweep",
        n=A.n, vectors="bit-equal", payload_rel=f"{rel:.3e}")


def glen_sweeps(gen, glen):
    """H10: the earlier sweeps on the 21-band glen operator (the paper's
    second Table-1 operator) against their plain versions, timed."""
    import torch
    from repro_torch.kernels.checksum import dia_column_checksum
    from repro_torch.kernels.pipebicgstab_fused import (
        pipebicgstab_fused, pipebicgstab_fused_plain)
    from repro_torch.kernels.pipecg_spmv_fused import (
        pipecg_spmv_fused, pipecg_spmv_fused_plain)
    from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_plain
    f64, dev, n = torch.float64, glen.device, glen.n
    nb = len(glen.offsets)
    check(nb == 21, f"glen has {nb} bands")
    x = torch.randn(n, generator=gen, device=dev, dtype=f64)
    y = spmv_dia(glen.offsets, glen.bands, x)
    check(torch.equal(y, spmv_dia_plain(glen.offsets, glen.bands, x)),
          "spmv_dia glen differs")
    ms = time_ms(lambda: spmv_dia(glen.offsets, glen.bands, x))
    plain_ms = time_ms(lambda: spmv_dia_plain(glen.offsets, glen.bands, x))
    b_ms, _ = bound(nbytes(glen.bands, x, y), 2.0 * nb * n, f64)
    say("kernel", name="spmv_dia", shape="glen", bands=nb, n=n,
        max_abs_err="0", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.4f}")
    X, R, U, P = (torch.randn((1, n), generator=gen, device=dev, dtype=f64)
                  for _ in range(4))
    a = torch.rand(1, generator=gen, device=dev, dtype=f64)
    b = torch.rand(1, generator=gen, device=dev, dtype=f64)
    invd = (1.0 / glen.diagonal()).contiguous()
    csum = dia_column_checksum(glen.offsets, glen.bands)
    args = (glen.offsets, glen.bands, invd, csum, X, R, U, P, a, b)
    got = pipecg_spmv_fused(*args)
    want = pipecg_spmv_fused_plain(*args)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[:4], want[:4])):
        check(torch.equal(g, w), f"pipecg_spmv_fused glen out{i} differs")
    rel = float(((got[4] - want[4]).abs()
                 / want[4].abs().clamp(min=1.0)).max())
    check(rel <= 1e-10, f"pipecg_spmv_fused glen partials {rel}")
    ms = time_ms(lambda: pipecg_spmv_fused(*args))
    plain_ms = time_ms(lambda: pipecg_spmv_fused_plain(*args))
    b_ms, _ = bound(nbytes(glen.bands, invd, csum, X, R, U, P, *got),
                    n * (4 * nb + 22), f64)
    say("kernel", name="pipecg_spmv_fused", shape="glen", bands=nb, k=1,
        accum="float64", storage="float64", partial_rel=f"{rel:.3e}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}")
    bands, csum, x, chains, sc = bicg_operands(gen, glen, f64, f64)
    args = (glen.offsets, bands, csum, x, *chains, *sc)
    got = pipebicgstab_fused(*args)
    want = pipebicgstab_fused_plain(*args)
    torch.cuda.synchronize()
    chains_equal("pipebicgstab_fused glen", got, want)
    C = torch.stack([want[i] for i in (1, 2, 3, 5, 6)] + [chains[6]])
    rel = gram_rel(got[7], want[7], C, csum)
    check(rel <= 1e-10, f"pipebicgstab_fused glen payload: {rel}")
    ms = time_ms(lambda: pipebicgstab_fused(*args))
    plain_ms = time_ms(lambda: pipebicgstab_fused_plain(*args))
    b_ms, _ = bicg_bound(glen, n, (bands, csum, x, *chains, *sc, *got), f64)
    say("kernel", name="pipebicgstab_fused", shape="glen", bands=nb, n=n,
        accum="float64", storage="float64", gram_rel=f"{rel:.3e}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}")


def chain_bound(A, n, tensors, l, acc):
    """(bound_ms, bound_by) of one chain sweep over n rows moving
    ``tensors``: per row 2l - 1 links of 2 n_bands + 1 flops and the
    (2l+1)(2l+2)/2 Gram products of 2 flops."""
    m = 2 * l + 1
    flops = n * ((2 * l - 1) * (2.0 * len(A.offsets) + 1) + m * (m + 1))
    return bound(nbytes(*tensors), flops, acc)


def chain_equal(name, got, want) -> None:
    """The chain: bit for bit, bf16 within one ulp."""
    import torch
    if got.dtype == torch.bfloat16:
        ulp = (want.double().abs() * 2.0 ** -7).clamp(min=2.0 ** -133)
        check(bool(((got.double() - want.double()).abs() <= ulp).all()),
              f"{name}: chain more than one bf16 ulp off")
    else:
        check(torch.equal(got, want), f"{name}: chain differs")


def chain_gram_rel(got, want, C) -> float:
    """Largest Gram gap relative to the sum of its terms' magnitudes."""
    import torch
    mags = C.abs() @ C.abs().T
    return float(((got - want).abs()
                  / mags.clamp(min=torch.finfo(mags.dtype).tiny)).max())


def chain_kernel(records, gen, tri, lap, glen):
    """#4: the one-device ghost-chain sweep against its plain version."""
    import torch
    from repro_torch.core.krylov import dia_inf_norm
    from repro_torch.kernels.pipecg_spmv_fused import (
        chain_plan, ghost_chain_fused, ghost_chain_fused_plain)
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    # lap2d at l = 4 runs the global-memory workspace, the rest the shared
    cases = [(tri, "tridiag", 2, f64, f64), (tri, "tridiag", 4, f64, f64),
             (lap, "lap2d", 2, f64, f64), (lap, "lap2d", 4, f64, f64),
             (glen, "glen", 4, f64, f64), (tri, "tridiag", 2, f32, f32),
             (tri, "tridiag", 2, f32, bf16)]
    for A, label, l, acc, sto in cases:
        dev = A.device
        bands = A.bands.to(sto).contiguous()
        p, r = (torch.randn(A.n, generator=gen, device=dev,
                            dtype=torch.float64).to(sto) for _ in range(2))
        theta = dia_inf_norm(A)
        args = (A.offsets, bands, p, r, theta, l)
        got = ghost_chain_fused(*args)
        want = ghost_chain_fused_plain(*args)
        torch.cuda.synchronize()
        chain_equal(f"ghost_chain_fused {label} l={l}", got[0], want[0])
        repeats(f"ghost_chain_fused {label} l={l}", ghost_chain_fused, args,
                got)
        wide = ghost_chain_fused_plain(A.offsets, bands.to(acc), p.to(acc),
                                       r.to(acc), theta, l)[0]
        rel = chain_gram_rel(got[1], want[1], wide)
        check(rel <= {f64: 1e-10, f32: 1e-5}[acc],
              f"ghost_chain_fused {label} l={l} Gram: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: ghost_chain_fused(*args))
        plain_ms = time_ms(lambda: ghost_chain_fused_plain(*args))
        b_ms, b_by = chain_bound(A, A.n, (bands, p, r, *got), l, acc)
        tile, _, shared = chain_plan(l * A.halo, 2 * l + 1,
                                     torch.finfo(acc).bits // 8)
        say("kernel", name="ghost_chain_fused", shape=label, n=A.n, l=l,
            bands=len(A.offsets), accum=str(acc)[6:], storage=str(sto)[6:],
            tile=tile, workspace="shared" if shared else "global",
            max_abs_err=f"{err:.3e}", gram_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            share=f"{b_ms / ms:.3f}")
        if (label, l, acc, sto) == ("tridiag", 2, f64, f64):
            records["ghost_chain_fused"] = dict(
                name="ghost_chain_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/ghost_chain.cu",
                replaces="src/repro/kernels/pipecg_spmv_fused.py:424",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def chain_rank_operands(A, P, q, p, r, l):
    """Rank q of P's chain operands cut from global vectors: the operator
    rows [lo - lh, hi + lh) and the p/r strips [lo - lh, lo) and
    [hi, hi + lh), zero beyond the matrix, as the exchanges give them."""
    import torch.nn.functional as F
    H, n = l * A.halo, A.n
    lo, hi = q * n // P, (q + 1) * n // P
    bands = F.pad(A.bands, (H, H))[:, lo:hi + 2 * H].to(p.dtype)
    strips = []
    for v in (p, r):
        wide = F.pad(v, (H, H))
        strips += [wide[lo:lo + H], wide[hi + H:hi + 2 * H]]
    ops_ = [bands, p[lo:hi], r[lo:hi], *strips]
    return [t.contiguous() for t in ops_], slice(lo, hi)


def chain_halo_kernel(records, gen, tri):
    """#5: the per-rank chain sweep on rank 1 of 4 (real strips and
    neighbour operator rows) against its plain version, and 4 slices
    against the one-device sweep."""
    import torch
    from repro_torch.core.krylov import dia_inf_norm
    from repro_torch.kernels.pipecg_spmv_fused import (
        ghost_chain_fused, ghost_chain_halo, ghost_chain_halo_plain)
    f64, l = torch.float64, 2
    p, r = (torch.randn(tri.n, generator=gen, device=tri.device, dtype=f64)
            for _ in range(2))
    theta = dia_inf_norm(tri)
    opnds, _ = chain_rank_operands(tri, RANKS, 1, p, r, l)
    args = (tri.offsets, *opnds, theta, l)
    got = ghost_chain_halo(*args)
    want = ghost_chain_halo_plain(*args)
    torch.cuda.synchronize()
    chain_equal("ghost_chain_halo", got[0], want[0])
    repeats("ghost_chain_halo", ghost_chain_halo, args, got)
    rel = chain_gram_rel(got[1], want[1], want[0])
    check(rel <= 1e-10, f"ghost_chain_halo Gram: {rel}")
    err = max_err(got, want)
    ms = time_ms(lambda: ghost_chain_halo(*args))
    plain_ms = time_ms(lambda: ghost_chain_halo_plain(*args))
    n = tri.n // RANKS
    b_ms, b_by = chain_bound(tri, n, (*opnds, *got), l, f64)
    say("kernel", name="ghost_chain_halo", shape="tridiag", ranks=RANKS,
        n_local=n, l=l, accum="float64", storage="float64",
        max_abs_err=f"{err:.3e}", gram_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
        share=f"{b_ms / ms:.3f}")
    records["ghost_chain_halo"] = dict(
        name="ghost_chain_halo", route="cuda",
        source="src/repro_torch/kernels/csrc/ghost_chain.cu",
        replaces="src/repro/kernels/pipecg_spmv_fused.py:445",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    whole = ghost_chain_fused(tri.offsets, tri.bands, p, r, theta, l)
    total = torch.zeros_like(whole[1])
    for q in range(RANKS):
        opnds, rows = chain_rank_operands(tri, RANKS, q, p, r, l)
        got = ghost_chain_halo(tri.offsets, *opnds, theta, l)
        check(torch.equal(got[0], whole[0][:, rows]),
              f"chain rank {q} differs from the one-device chain")
        total = total + got[1]
    torch.cuda.synchronize()
    rel = chain_gram_rel(total, whole[1], whole[0])
    check(rel <= 1e-10, f"rank Grams sum off by {rel}")
    say("kernel", check="4 rank slices == one-device ghost chain", n=tri.n,
        l=l, chain="bit-equal", gram_rel=f"{rel:.3e}")


def sparse_yardstick(B, x):
    """A ``torch.sparse`` copy of BsrMatrix ``B`` and its layout name: BSR
    where torch runs its mv for ``x``'s dtype on this card, else CSR (the
    library yardstick; the port never calls it)."""
    import torch
    nbr, deg, bs = B.n_block_rows, B.max_deg, B.bs
    dev = B.device
    rows = torch.arange(nbr, device=dev).repeat_interleave(deg)
    with warnings.catch_warnings():  # torch.sparse's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.stack([rows, B.indices.reshape(-1).long()]),
            B.blocks.reshape(-1, bs, bs), (nbr, nbr, bs, bs)).coalesce()
        (r, c), vals = coo.indices(), coo.values()
        crow = torch.zeros(nbr + 1, dtype=torch.long, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=nbr), 0)
        bsr = torch.sparse_bsr_tensor(crow, c, vals, size=(B.n, B.n))
        try:
            torch.mv(bsr, x)
            return bsr, "bsr"
        except (RuntimeError, NotImplementedError):
            pass
        i, j = torch.meshgrid(torch.arange(bs, device=dev),
                              torch.arange(bs, device=dev), indexing="ij")
        srows = (r[:, None, None] * bs + i).reshape(-1)
        scols = (c[:, None, None] * bs + j).reshape(-1)
        return torch.sparse_coo_tensor(
            torch.stack([srows, scols]), vals.reshape(-1),
            (B.n, B.n)).coalesce().to_sparse_csr(), "csr"


def scattered(B, gen):
    """``B`` under a random symmetric permutation of its block rows."""
    import torch
    nbr = B.n_block_rows
    perm = torch.randperm(nbr, generator=gen, device=gen.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(nbr, device=gen.device)
    return type(B)(indices=inv[B.indices[perm].long()].int().contiguous(),
                   blocks=B.blocks[perm].contiguous())


def recompute_share(B) -> float:
    """The share of ``pipecg_bsr_fused``'s gathers that recompute u': those
    whose block column lies outside the CTA's range of block rows (one
    CTA per build.BLOCK rows)."""
    import torch
    from repro_torch.kernels import build
    per_cta = build.BLOCK // B.bs
    cta = torch.arange(B.n_block_rows, device=B.device)[:, None] // per_cta
    return float(((B.indices.long() // per_cta) != cta).double().mean())


def bsr_kernels(records, gen, tri, lap):
    """#10 spmv_bsr and #11 pipecg_bsr_fused against their plain versions
    on ex23-bsr4 and lap2d-bsr4 (``dia_to_bsr`` at bs 4, timed on the
    host), k = 1, ex23-bsr4 at k = 8 and in float32, and lap2d-bsr4 under
    a random block permutation."""
    import torch
    from repro_torch.core.krylov import BsrMatrix, dia_to_bsr
    from repro_torch.kernels.spmv_bsr import (pipecg_bsr_fused,
                                              pipecg_bsr_fused_plain,
                                              spmv_bsr, spmv_bsr_plain)
    f64, f32 = torch.float64, torch.float32
    ops_ = {}
    for A, label in ((tri, "ex23-bsr4"), (lap, "lap2d-bsr4")):
        t0 = time.perf_counter()
        ops_[label] = dia_to_bsr(A, bs=BSR_BS)
        B = ops_[label]
        say("kernel", name="dia_to_bsr", shape=label, n=B.n,
            block_rows=B.n_block_rows, deg=B.max_deg, bs=B.bs,
            host_seconds=f"{time.perf_counter() - t0:.3f}")
    ops_["lap2d-bsr4-scattered"] = scattered(ops_["lap2d-bsr4"], gen)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=f64).to(dt)

    cases = [("ex23-bsr4", 1, f64), ("lap2d-bsr4", 1, f64),
             ("ex23-bsr4", 8, f64), ("ex23-bsr4", 1, f32),
             ("lap2d-bsr4-scattered", 1, f64)]
    for label, k, dt in cases:
        B = ops_[label]
        B = BsrMatrix(indices=B.indices, blocks=B.blocks.to(dt))
        n, deg, bs = B.n, B.max_deg, B.bs
        x = randn((k, n), dt)
        y = spmv_bsr(B.indices, B.blocks, x)
        want = spmv_bsr_plain(B.indices, B.blocks, x)
        torch.cuda.synchronize()
        check(torch.equal(y, want), f"spmv_bsr {label} k={k} {dt} differs")
        err = max_err([y], [want])
        ms = time_ms(lambda: spmv_bsr(B.indices, B.blocks, x))
        plain_ms = time_ms(lambda: spmv_bsr_plain(B.indices, B.blocks, x))
        b_ms, b_by = bound(nbytes(B.indices, B.blocks, x, y),
                           2.0 * k * n * deg * bs, dt)
        lib_ms, layout = None, None
        if k == 1:
            mat, layout = sparse_yardstick(B, x[0])
            lib = torch.mv(mat, x[0])
            scale = float(want.abs().max())
            check(max_err([lib], [want[0]]) <= 1e-5 * scale if dt == f32
                  else max_err([lib], [want[0]]) <= 1e-12 * scale,
                  f"{layout} yardstick disagrees")
            lib_ms = time_ms(lambda: torch.mv(mat, x[0]))
        say("kernel", name="spmv_bsr", shape=label, k=k, dtype=str(dt)[6:],
            max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            library_ms=f"{lib_ms:.4f}" if lib_ms else None,
            library=f"torch.sparse {layout} mv" if layout else None)
        if (label, k, dt) == ("ex23-bsr4", 1, f64):
            records["spmv_bsr"] = dict(
                name="spmv_bsr", route="cuda",
                source="src/repro_torch/kernels/csrc/spmv_bsr.cu",
                replaces="src/repro/kernels/spmv_bsr.py:51",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

        r, u, p = (randn((k, n), dt) for _ in range(3))
        a = torch.rand(k, generator=gen, device=gen.device, dtype=f64).to(dt)
        b = torch.rand(k, generator=gen, device=gen.device, dtype=f64).to(dt)
        invd = (1.0 / B.diagonal()).contiguous()
        csum = B.column_checksum()
        args = (B.indices, B.blocks, invd, csum, x, r, u, p, a, b)
        got = pipecg_bsr_fused(*args)
        want = pipecg_bsr_fused_plain(*args)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got[:4], want[:4])):
            check(torch.equal(g, w),
                  f"pipecg_bsr_fused {label} k={k} {dt} out{i} differs")
        u2, r2 = want[2], want[1]
        w2 = spmv_bsr_plain(B.indices, B.blocks, u2)
        mags = torch.stack(
            [t.abs().sum(-1) for t in (r2 * u2, w2 * u2, r2 * r2, r2 * w2,
                                       w2 * w2)]
            + [w2.abs().sum(-1) + (csum * u2).abs().sum(-1)], -1)
        rel = float(((got[4] - want[4]).abs() / mags).max())
        check(rel <= {f64: 1e-10, f32: 1e-5}[dt],
              f"pipecg_bsr_fused partials {label}: {rel}")
        err = max_err(got, want)
        ms = time_ms(lambda: pipecg_bsr_fused(*args))
        plain_ms = time_ms(lambda: pipecg_bsr_fused_plain(*args))
        b_ms, b_by = bound(nbytes(*args, *got), k * n * (4.0 * deg * bs + 21),
                           dt)
        say("kernel", name="pipecg_bsr_fused", shape=label, k=k,
            dtype=str(dt)[6:], max_abs_err=f"{err:.3e}",
            partial_rel=f"{rel:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            words_per_row=B.words_per_iter(),
            recompute_share=f"{recompute_share(B):.4f}")
        if (label, k, dt) == ("ex23-bsr4", 1, f64):
            records["pipecg_bsr_fused"] = dict(
                name="pipecg_bsr_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/spmv_bsr.cu",
                replaces="src/repro/kernels/spmv_bsr.py:146",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def lm_kernels(records, gen):
    """#12 flash_attention and #13 wkv_recurrent against their plain
    versions: flash at the [serve] prefill's shape (bf16, causal, timed
    beside SDPA), ragged f32 causal and f32 non-causal; wkv at rwkv6-7b's
    shape with f32 and bf16 inputs, random decays and logw = -8, -1e-4."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import (bf16_error, flash_attention,
                                                flash_attention_plain)
    from repro_torch.kernels.wkv import wkv_recurrent, wkv_recurrent_plain
    dev = gen.device
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for shape, dt, causal in ((FLASH_SHAPE, bf16, True),
                              ((3, 200, 64), f32, True),
                              ((2, 256, 64), f32, False)):
        q, k, v = (randn(shape, dt) for _ in range(3))
        got = flash_attention(q, k, v, causal)
        # the plain version in float32 on the same values: the oracle
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        bar = None
        if dt == bf16:
            bar = bf16_error(got, want, v)
            check(bar[0] <= 1.0 and bar[1] <= 1.0,
                  f"flash_attention {shape}: {bar} of the bf16 bar")
        else:
            check(err <= FLASH_F32_TOL, f"flash_attention {shape}: {err}")
        BH, S, D = shape
        flops = 4.0 * BH * D * (S * (S + 1) / 2 if causal else S * S)
        b_ms, b_by = bound(nbytes(q, k, v, got), flops, dt)
        ms = time_ms(lambda: flash_attention(q, k, v, causal))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, causal))
        q4, k4, v4 = (t.view(1, *shape) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)[0]
        lib_err = max_err([lib], [want])
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        say("kernel", name="flash_attention", shape="x".join(map(str, shape)),
            dtype=str(dt)[6:], causal=causal, max_abs_err=f"{err:.3e}",
            bar_elem=f"{bar[0]:.3f}" if bar else None,
            bar_rms=f"{bar[1]:.3f}" if bar else None,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            library_ms=f"{lib_ms:.4f}", library_max_abs_err=f"{lib_err:.3e}",
            tflops=f"{flops / ms / 1e9:.2f}")
        if shape == FLASH_SHAPE:
            records["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attn.cu",
                replaces="src/repro/kernels/flash_attn.py:64",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    BH, T, D = WKV_SHAPE
    for dt in (f32, bf16):
        r, k, v = (randn(WKV_SHAPE, dt) for _ in range(3))
        u = (0.3 * torch.randn((BH, D), generator=gen, device=dev)).to(dt)
        rand_w = -torch.exp(torch.randn(WKV_SHAPE, generator=gen, device=dev)
                            - 2.0)
        for label, logw in (("random", rand_w),
                            ("-8", torch.full(WKV_SHAPE, -8.0, device=dev)),
                            ("-1e-4", torch.full(WKV_SHAPE, -1e-4,
                                                 device=dev))):
            logw = logw.to(dt)
            got = wkv_recurrent(r, k, v, logw, u)
            want = wkv_recurrent_plain(r, k, v, logw, u)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"wkv {label} not finite")
            repeats(f"wkv_recurrent {dt} logw={label}",
                    lambda *a: (wkv_recurrent(*a),), (r, k, v, logw, u),
                    [got])
            err = max_err([got], [want])
            scale = float(want.abs().max())
            check(err <= WKV_REL_TOL * scale,
                  f"wkv_recurrent {dt} logw={label}: {err} of {scale}")
            line = dict(name="wkv_recurrent", shape="x".join(map(str,
                                                                 WKV_SHAPE)),
                        dtype=str(dt)[6:], logw=label,
                        max_abs_err=f"{err:.3e}",
                        rel_to_max=f"{err / scale:.3e}", repeat="bit-equal")
            if label == "random":
                flops = 5.0 * BH * T * D * D
                b_ms, b_by = bound(nbytes(r, k, v, logw, u, got), flops, f32)
                ms = time_ms(lambda: wkv_recurrent(r, k, v, logw, u))
                plain_ms = time_ms(lambda: wkv_recurrent_plain(
                    r, k, v, logw, u), reps=3)
                line.update(ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
                            bound_ms=f"{b_ms:.4f}", bound_by=b_by)
                if dt == f32:
                    records["wkv_recurrent"] = dict(
                        name="wkv_recurrent", route="cuda",
                        source="src/repro_torch/kernels/csrc/wkv.cu",
                        replaces="src/repro/kernels/wkv.py:37",
                        launches=0, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None)
            say("kernel", **line)


def phase_main_path(records):
    """The ex23 solve and its siblings, with the launch counts around them.

    The counts are set to 0 before the path's solves and read right after
    them; the fused solves that only serve as comparisons run later.
    """
    import torch
    from repro_torch.core.krylov import (SolverOptions, pipecg, pipecg_multi,
                                         pipecr)
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    A, b = ex23(gen)
    B = torch.randn(8, N_EX23, generator=gen, device=dev, dtype=torch.float64)
    half = lambda z: 0.5 * z  # noqa: E731  an opaque callable M
    cb_iters = 100

    def fused(**kw):
        return SolverOptions(engine="fused", **kw)

    def counted(fn):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.launch_counts()
        return out, dt, {k: after[k] - before[k] for k in after}

    ops.reset_launch_counts()
    # the paper's experiment: 5000 forced iterates on the fused engine
    res, dt, d_main = counted(lambda: pipecg(A, b, options=fused(
        maxiter=MAXITER)))
    jac, _, d_jac = counted(lambda: pipecg(A, b, options=fused(
        maxiter=CHECK_ITERS, M="jacobi")))
    multi, dt_multi, d_multi = counted(lambda: pipecg_multi(
        A, B, maxiter=CHECK_ITERS, engine="fused"))
    pcr, _, _ = counted(lambda: pipecr(A, b, options=fused(
        maxiter=CHECK_ITERS)))
    cb, dt_cb, d_cb = counted(lambda: pipecg(A, b, options=fused(
        maxiter=cb_iters, M=half)))
    counts = ops.launch_counts()
    say("main", launches=json.dumps(counts, separators=(",", ":")))
    for name in ONE_DEVICE:
        records[name]["launches"] = counts[name]
        check(counts[name] > 0, f"{name} never launched on the main path")

    check(d_main["pipecg_spmv_fused"] == MAXITER,
          f"pipecg_spmv_fused ran {d_main['pipecg_spmv_fused']} times")
    check(d_main["spmv_dia"] == 2, f"init SpMVs: {d_main['spmv_dia']}")
    check(d_main["pipecg_fused"] == 0, "the sweep path took the fallback")
    hist = res.res_history
    check(tuple(hist.shape) == (MAXITER,), f"history {tuple(hist.shape)}")
    check(bool(torch.isfinite(hist).all())
          and bool(torch.isfinite(res.x).all()), "non-finite solve")
    check(int(res.iters) == MAXITER, f"iters {int(res.iters)}")
    say("main", solve="pipecg fused", n=N_EX23, maxiter=MAXITER,
        seconds=f"{dt:.3f}", ms_per_iter=f"{dt / MAXITER * 1e3:.4f}",
        kernel_ms=f"{records['pipecg_spmv_fused']['ms']:.4f}",
        res0=f"{float(hist[0]):.6e}", res_last=f"{float(hist[-1]):.6e}",
        launches=json.dumps(d_main, separators=(",", ":")))
    naive, dt_naive, _ = counted(lambda: pipecg(A, b, options=SolverOptions(
        engine="naive", maxiter=CHECK_ITERS)))
    gap = hist_close(naive.res_history, hist[:CHECK_ITERS])
    say("main", check="fused vs naive history", iters=CHECK_ITERS,
        max_rel_gap=f"{gap:.3e}",
        naive_ms_per_iter=f"{dt_naive / CHECK_ITERS * 1e3:.4f}")

    check(d_jac["pipecg_spmv_fused"] == CHECK_ITERS, "jacobi sweep count")
    jn = pipecg(A, b, options=SolverOptions(engine="naive",
                                            maxiter=CHECK_ITERS, M="jacobi"))
    gap = hist_close(jn.res_history, jac.res_history)
    say("main", check="jacobi fused vs naive", max_rel_gap=f"{gap:.3e}")

    check(d_multi["pipecg_spmv_fused"] == CHECK_ITERS,
          "pipecg_multi: one sweep per iteration for all 8 systems")
    check(tuple(multi.res_history.shape) == (8, CHECK_ITERS), "multi shape")
    gaps = []
    for j in range(8):
        one = pipecg(A, B[j], options=fused(maxiter=CHECK_ITERS))
        gaps.append(hist_close(one.res_history, multi.res_history[j],
                               rtol=1e-12))
    say("main", check="pipecg_multi k=8 vs 8 single solves",
        max_rel_gap=f"{max(gaps):.3e}",
        ms_per_iter=f"{dt_multi / CHECK_ITERS * 1e3:.4f}")

    pcrn = pipecr(A, b, options=SolverOptions(engine="naive",
                                              maxiter=CHECK_ITERS))
    gap = hist_close(pcrn.res_history, pcr.res_history)
    say("main", check="pipecr fused vs naive", max_rel_gap=f"{gap:.3e}")

    check(d_cb["pipecg_fused"] == cb_iters, f"pipecg_fused ran {d_cb}")
    check(d_cb["spmv_dia"] == cb_iters + 3, f"fallback SpMVs {d_cb}")
    check(d_cb["pipecg_spmv_fused"] == 0, "a callable M reached the sweep")
    cbn = pipecg(A, b, options=SolverOptions(engine="naive",
                                             maxiter=cb_iters, M=half))
    gap = hist_close(cbn.res_history, cb.res_history)
    say("main", check="callable-M fallback vs naive",
        max_rel_gap=f"{gap:.3e}",
        ms_per_iter=f"{dt_cb / cb_iters * 1e3:.4f}")


def convdiff(gen):
    """The nonsymmetric convection-diffusion tridiag(-1.4, 2.2, -0.6) at
    ex23's n and a float64 right-hand side drawn from ``gen``."""
    import torch
    from repro_torch.core.krylov import convection_diffusion
    b = torch.randn(N_EX23, generator=gen, device=gen.device,
                    dtype=torch.float64)
    return convection_diffusion(N_EX23, device=gen.device), b


def phase_bicgstab(records):
    """p-BiCGStab on one device: the forced 5000-iterate solve with the
    launch counts set to 0 just before it and read just after it, then
    the tol solve, classical BiCGStab and a callable M."""
    import torch
    from repro_torch.core.krylov import SolverOptions, bicgstab, pipebicgstab
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    A, b = convdiff(torch.Generator(device=dev).manual_seed(3))
    bnorm = float(torch.linalg.norm(b))

    def opts(**kw):
        return SolverOptions(**dict(dict(M="jacobi", engine="fused",
                                         tol=0.0), **kw))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipebicgstab(A, b, options=opts(maxiter=MAXITER))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    records["pipebicgstab_fused"]["launches"] = counts["pipebicgstab_fused"]
    check(counts["pipebicgstab_fused"] == MAXITER,
          f"pipebicgstab_fused ran {counts['pipebicgstab_fused']} times")
    check(counts["spmv_dia"] == 0, f"the init reached the SpMV: {counts}")
    check(sum(counts.values()) == MAXITER, f"other kernels ran: {counts}")
    hist = res.res_history
    check(tuple(hist.shape) == (MAXITER,), f"history {tuple(hist.shape)}")
    check(bool(torch.isfinite(hist).all())
          and bool(torch.isfinite(res.x).all())
          and bool(torch.isfinite(res.detect_history).all()),
          "non-finite p-BiCGStab solve")
    true_res = float(torch.linalg.norm(b - A.matvec(res.x))) / bnorm
    check(float(hist[-1]) / bnorm < BICG_REC_MAX,
          f"forced recurrence residual {float(hist[-1]) / bnorm}")
    check(true_res < BICG_DRIFT_MAX, f"forced x's true residual {true_res}")
    say("bicgstab", solve="pipebicgstab fused jacobi", n=N_EX23,
        maxiter=MAXITER, seconds=f"{dt:.3f}", true_rel_res=f"{true_res:.3e}",
        ms_per_iter=f"{dt / MAXITER * 1e3:.4f}",
        kernel_ms=f"{records['pipebicgstab_fused']['ms']:.4f}",
        res0=f"{float(hist[0]):.6e}", res_min=f"{float(hist.min()):.6e}",
        res_last=f"{float(hist[-1]):.6e}",
        max_abs_checksum=f"{float(res.detect_history.abs().max()):.3e}",
        launches=json.dumps(counts, separators=(",", ":")))
    naive = pipebicgstab(A, b, options=opts(maxiter=BICG_CHECK,
                                            engine="naive"))
    gap = hist_close(naive.res_history, hist[:BICG_CHECK])
    say("bicgstab", check="fused vs naive history", iters=BICG_CHECK,
        max_rel_gap=f"{gap:.3e}")
    pinned = pipebicgstab(A, b, options=opts(maxiter=MAXITER, rr=BICG_RR))
    pinned_true = float(torch.linalg.norm(b - A.matvec(pinned.x))) / bnorm
    check(pinned_true < 1e-12,
          f"forced x with rr={BICG_RR}: true residual {pinned_true}")
    say("bicgstab", check=f"forced x pinned by rr={BICG_RR}",
        maxiter=MAXITER, true_rel_res=f"{pinned_true:.3e}",
        rec_rel_res=f"{float(pinned.res_norm) / bnorm:.3e}")

    tol_f = pipebicgstab(A, b, options=opts(maxiter=BICG_TOL_ITERS,
                                            tol=BICG_TOL))
    tol_n = pipebicgstab(A, b, options=opts(maxiter=BICG_TOL_ITERS,
                                            tol=BICG_TOL, engine="naive"))
    it_f, it_n = int(tol_f.iters), int(tol_n.iters)
    check(it_f == it_n < BICG_TOL_ITERS, f"tol iters {it_f} vs {it_n}")
    check(float(tol_f.res_norm) <= BICG_TOL * bnorm * 1.01,
          f"tol solve stopped at {float(tol_f.res_norm)}")
    tol_true = float(torch.linalg.norm(b - A.matvec(tol_f.x))) / bnorm
    check(tol_true <= 10 * BICG_TOL, f"tol solve's true residual {tol_true}")
    classic = bicgstab(A, b, options=opts(maxiter=BICG_TOL_ITERS,
                                          tol=BICG_TOL))
    check(int(classic.iters) < BICG_TOL_ITERS
          and float(classic.res_norm) <= BICG_TOL * bnorm * 1.01,
          f"classical bicgstab: {int(classic.iters)} iters, "
          f"{float(classic.res_norm)}")
    say("bicgstab", check=f"tol={BICG_TOL}", fused_iters=it_f,
        true_rel_res=f"{tol_true:.3e}",
        naive_iters=it_n, bicgstab_iters=int(classic.iters),
        res_norm=f"{float(tol_f.res_norm):.6e}",
        bicgstab_res_norm=f"{float(classic.res_norm):.6e}")

    invd = 1.0 / A.diagonal()
    M = lambda z: invd * z  # noqa: E731  an opaque linear M
    before = ops.launch_counts()
    cb = pipebicgstab(A, b, options=opts(maxiter=BICG_CHECK, M=M))
    after = ops.launch_counts()
    d = {k: after[k] - before[k] for k in after}
    check(d["spmv_dia"] == 3 + 2 * BICG_CHECK and
          d["pipebicgstab_fused"] == 0, f"callable-M launches {d}")
    cbn = pipebicgstab(A, b, options=opts(maxiter=BICG_CHECK, M=M,
                                          engine="naive"))
    gap = hist_close(cbn.res_history, cb.res_history)
    say("bicgstab", check="callable M through the engine's SpMV vs naive",
        launches=json.dumps(d, separators=(",", ":")),
        max_rel_gap=f"{gap:.3e}")


def rel_dev(hist, ref, floor_rel=COOLS_FLOOR) -> float:
    """Largest relative deviation of ``hist`` from ``ref`` above the floor
    (the Cools gate of tests/test_pipeline_depth.py)."""
    h, g = hist.double().cpu(), ref.double().cpu()
    k = min(h.numel(), g.numel())
    h, g = h[:k], g[:k]
    mask = g > floor_rel * float(g.max())
    check(int(mask.sum()) > 0, "history entirely below the floor")
    return float(((h[mask] - g[mask]).abs() / g[mask]).max())


def phase_depth(records):
    """Depth-l pipelined CG on one device: the 5000-iterate ex23 solve at
    l = 2 and at l = 4, each with the launch counts set to 0 just before
    it and read just after it, against engine="naive" and the depth-1
    PIPECG history; then pgmres_l through the SpMV kernel."""
    import torch
    from repro_torch.core.krylov import (SolverOptions, pgmres_l, pipecg,
                                         pipecg_l)
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    A, b = ex23(torch.Generator(device=dev).manual_seed(4))
    bn = float(torch.linalg.norm(b))
    depth1 = pipecg(A, b, options=SolverOptions(engine="fused",
                                                maxiter=MAXITER))
    for l in DEPTHS:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipecg_l(A, b, options=SolverOptions(
            engine="fused", maxiter=MAXITER, depth=l))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        blocks = -(-MAXITER // l)
        check(counts["ghost_chain_fused"] == blocks,
              f"l={l}: ghost_chain_fused ran {counts['ghost_chain_fused']}")
        check(sum(counts.values()) == blocks, f"l={l}: other kernels {counts}")
        if l == DEPTHS[0]:
            records["ghost_chain_fused"]["launches"] = counts[
                "ghost_chain_fused"]
        hist = res.res_history
        check(tuple(hist.shape) == (MAXITER,), f"history {tuple(hist.shape)}")
        check(bool(torch.isfinite(hist).all())
              and bool(torch.isfinite(res.x).all()), "non-finite depth solve")
        check(int(res.iters) == MAXITER, f"iters {int(res.iters)}")
        true_res = float(torch.linalg.norm(b - A.matvec(res.x))) / bn
        rec_res = float(res.res_norm) / bn
        check(abs(true_res - rec_res) <= DEPTH_GAP_MAX,
              f"l={l}: true {true_res} vs recurrence {rec_res}")
        naive = pipecg_l(A, b, options=SolverOptions(
            engine="naive", maxiter=CHECK_ITERS, depth=l))
        gap = hist_close(naive.res_history, hist[:CHECK_ITERS])
        cools = rel_dev(hist[:CHECK_ITERS],
                        depth1.res_history[:CHECK_ITERS])
        check(cools <= COOLS_RTOL, f"l={l}: {cools} from depth 1")
        say("depth", solve=f"pipecg_l fused l={l}", n=N_EX23,
            maxiter=MAXITER, seconds=f"{dt:.3f}",
            ms_per_iter=f"{dt / MAXITER * 1e3:.4f}",
            launches=json.dumps(counts, separators=(",", ":")),
            true_rel_res=f"{true_res:.6e}", rec_rel_res=f"{rec_res:.6e}",
            naive_max_rel_gap=f"{gap:.3e}", cools_dev_200=f"{cools:.3e}",
            cools_dev_all=f"{rel_dev(hist, depth1.res_history):.3e}",
            depth1_rec_rel_res=f"{float(depth1.res_norm) / bn:.6e}")

    ops.reset_launch_counts()
    fused = pgmres_l(A, b, restart=PGMRES_RESTART, l=2, engine="fused")
    counts = ops.launch_counts()
    check(counts["spmv_dia"] == PGMRES_RESTART + 1,
          f"pgmres_l SpMVs: {counts}")
    naive = pgmres_l(A, b, restart=PGMRES_RESTART, l=2, engine="naive")
    gap = hist_close(naive.res_history, fused.res_history)
    true_res = float(torch.linalg.norm(b - A.matvec(fused.x))) / bn
    check(abs(true_res - float(fused.res_norm) / bn) <= 1e-6,
          f"pgmres_l: true {true_res} vs {float(fused.res_norm) / bn}")
    say("depth", solve=f"pgmres_l fused l=2 restart={PGMRES_RESTART}",
        launches=json.dumps(counts, separators=(",", ":")),
        max_rel_gap=f"{gap:.3e}", true_rel_res=f"{true_res:.6e}")


def phase_gmres(records):
    """GMRES and PGMRES (Algorithms 1 and 2) on ex23 at full width through
    the fused engine, each with the launch counts set to 0 just before it
    and read just after it.

    One ``gmres`` cycle of restart m: one ``fused_dots`` an Arnoldi step
    (m), one ``spmv_dia`` a step plus the initial residual and the final
    one (m + 2), nothing else.  ``pgmres`` runs m + 2 iterations (two fill
    the pipeline): m + 2 ``fused_dots`` and m + 4 ``spmv_dia``.  Then the
    histories against ``engine="naive"`` (H6: above 1e-4 of the first
    residual), gmres vs pgmres x, restarted PGMRES vs restarted GMRES, and
    the progressive Givens recurrence alone, timed.
    """
    import torch
    from repro_torch.core.krylov import (SolverOptions, gmres,
                                         gmres_restarted, pgmres)
    from repro_torch.core.krylov.gmres import givens_history
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    A, b = ex23(torch.Generator(device=dev).manual_seed(5))
    m = GMRES_RESTART
    fused = SolverOptions(engine="fused")
    runs = {}
    for name, solver, steps in (("gmres", gmres, m),
                                ("pgmres", pgmres, m + 2)):
        solver(A, b, restart=m, options=fused)     # warm up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver(A, b, restart=m, options=fused)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(counts["fused_dots"] == steps,
              f"{name}: fused_dots ran {counts['fused_dots']}, not {steps}")
        check(counts["spmv_dia"] == steps + 2,
              f"{name}: spmv_dia ran {counts['spmv_dia']}, not {steps + 2}")
        check(sum(counts.values()) == 2 * steps + 2,
              f"{name}: other kernels {counts}")
        for k in ("fused_dots", "spmv_dia"):
            records[k]["launches"] += counts[k]
        hist = res.res_history
        check(tuple(hist.shape) == (m,), f"{name} history {hist.shape}")
        check(int(res.iters) == m, f"{name} iters {int(res.iters)}")
        check(bool(torch.isfinite(hist).all())
              and bool(torch.isfinite(res.x).all()), f"non-finite {name}")
        naive = solver(A, b, restart=m, options=SolverOptions(engine="naive"))
        gap = hist_close(naive.res_history, hist, floor_rel=1e-4)
        x_gap = float((res.x - naive.x).abs().max() / naive.x.abs().max())
        check(x_gap <= 1e-10, f"{name} fused vs naive x {x_gap}")
        runs[name] = res
        say("gmres", solve=f"{name} fused restart={m}", n=N_EX23,
            seconds=f"{dt:.4f}", ms_per_step=f"{dt / steps * 1e3:.4f}",
            launches=json.dumps({k: v for k, v in counts.items() if v},
                                separators=(",", ":")),
            launches_per_step=" ".join(f"{k}={v / steps:.3f}"
                                       for k, v in counts.items() if v),
            res_last=f"{float(hist[-1]):.6e}",
            res_norm=f"{float(res.res_norm):.6e}",
            naive_max_rel_gap=f"{gap:.3e}", naive_x_rel_gap=f"{x_gap:.3e}")
    g, p = runs["gmres"], runs["pgmres"]
    check(torch.allclose(p.x, g.x, rtol=GMRES_RTOL, atol=GMRES_ATOL),
          "gmres vs pgmres x")
    check(abs(float(g.res_norm) - float(p.res_norm)) < 1e-6,
          "gmres vs pgmres residual")
    cycles = {inner.__name__: gmres_restarted(A, b, restart=m, cycles=2,
                                              inner=inner, engine="fused")
              for inner in (gmres, pgmres)}
    rg, rp = cycles["gmres"], cycles["pgmres"]
    check(int(rg.iters) == int(rp.iters) == 2 * m, "restarted iters")
    check(torch.allclose(rp.x, rg.x, rtol=GMRES_RTOL, atol=GMRES_ATOL),
          "restarted pgmres vs restarted gmres x")
    say("gmres", check="gmres vs pgmres",
        x_max_abs_gap=f"{float((g.x - p.x).abs().max()):.3e}",
        restarted_x_max_abs_gap=f"{float((rg.x - rp.x).abs().max()):.3e}",
        restarted_res=f"{float(rg.res_norm):.6e}/{float(rp.res_norm):.6e}")
    # the progressive Givens recurrence alone: after the Arnoldi loop, one
    # copy of H to the host and m (m + 1) / 2 rotations there
    H = torch.randn((m + 1, m), generator=torch.Generator(device=dev)
                    .manual_seed(6), device=dev, dtype=torch.float64)
    beta = torch.ones((), dtype=H.dtype, device=dev)
    givens_history(H, beta)
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        hist = givens_history(H, beta)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    check(tuple(hist.shape) == (m,) and bool(torch.isfinite(hist).all()),
          "givens_history")
    busy_us, kernels = device_busy(lambda: givens_history(H, beta))
    say("gmres", givens=f"{m} columns after the loop, on the host",
        host_ms_per_cycle=f"{host_ms:.3f}",
        device_busy_us_per_cycle=f"{busy_us:.1f}"
        if busy_us else "not measured",
        device_ops_per_cycle=kernels)


def device_busy(fn) -> tuple:
    """(device-busy µs, kernels and copies) of one call of ``fn``, from
    ``torch.profiler``'s device events; (0, 0) where it shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, count = 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += us
            count += ev.count
    return busy, count


def phase_bsr(records):
    """PIPECG on BSR operators on one device: the 5000-iterate ex23-bsr4
    solve with the launch counts set to 0 just before it and read just
    after it, held to naive on the same BsrMatrix and to the DIA PIPECG
    on ex23; then Jacobi on lap2d-bsr4, pipecg_multi (k=8), pipecr and
    the callable-M fallback, each with its counts."""
    import torch
    from repro_torch.core.krylov import (SolverOptions, dia_to_bsr,
                                         laplacian_2d, pipecg, pipecg_multi,
                                         pipecr, true_residual_norm)
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    A, b = ex23(gen)
    B = dia_to_bsr(A, bs=BSR_BS)
    L = dia_to_bsr(laplacian_2d(NX_LAP, NX_LAP, device=dev), bs=BSR_BS)
    bl = torch.randn(L.n, generator=gen, device=dev, dtype=torch.float64)
    BB = torch.randn(8, B.n, generator=gen, device=dev, dtype=torch.float64)
    half = lambda z: 0.5 * z  # noqa: E731  an opaque callable M
    cb_iters = 100
    bn = float(torch.linalg.norm(b))

    def run(fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, ops.launch_counts()

    def only(counts, want, what):
        extra = {k: v for k, v in counts.items() if v and k not in want}
        check(all(counts[k] == v for k, v in want.items()) and not extra,
              f"{what}: launches {counts}, expected {want}")

    def fused(**kw):
        return SolverOptions(engine="fused", **kw)

    res, dt, counts = run(lambda: pipecg(B, b, options=fused(
        maxiter=MAXITER)))
    only(counts, {"spmv_bsr": 2, "pipecg_bsr_fused": MAXITER}, "bsr main")
    for name in ("spmv_bsr", "pipecg_bsr_fused"):
        records[name]["launches"] = counts[name]
    hist = res.res_history
    check(tuple(hist.shape) == (MAXITER,), f"history {tuple(hist.shape)}")
    check(bool(torch.isfinite(hist).all())
          and bool(torch.isfinite(res.x).all()), "non-finite BSR solve")
    check(int(res.iters) == MAXITER, f"iters {int(res.iters)}")
    true_res = true_residual_norm(B, b, res.x) / bn
    rec_res = float(res.res_norm) / bn
    check(abs(true_res - rec_res) <= DEPTH_GAP_MAX,
          f"BSR: true {true_res} vs recurrence {rec_res}")
    say("bsr", solve="pipecg fused", shape="ex23-bsr4", n=B.n,
        maxiter=MAXITER, seconds=f"{dt:.3f}",
        ms_per_iter=f"{dt / MAXITER * 1e3:.4f}",
        kernel_ms=f"{records['pipecg_bsr_fused']['ms']:.4f}",
        launches=json.dumps(counts, separators=(",", ":")),
        true_rel_res=f"{true_res:.6e}", rec_rel_res=f"{rec_res:.6e}",
        max_abs_detect=f"{float(res.detect_history.abs().max()):.3e}")
    naive = pipecg(B, b, options=SolverOptions(engine="naive",
                                               maxiter=CHECK_ITERS))
    gap_n = hist_close(naive.res_history, hist[:CHECK_ITERS])
    dia = pipecg(A, b, options=fused(maxiter=CHECK_ITERS))
    gap_d = hist_close(dia.res_history, hist[:CHECK_ITERS])
    say("bsr", check="ex23-bsr4 fused vs naive and vs DIA PIPECG on ex23",
        iters=CHECK_ITERS, naive_max_rel_gap=f"{gap_n:.3e}",
        dia_max_rel_gap=f"{gap_d:.3e}")

    jac, dt, counts = run(lambda: pipecg(L, bl, options=fused(
        maxiter=CHECK_ITERS, M="jacobi")))
    only(counts, {"spmv_bsr": 2, "pipecg_bsr_fused": CHECK_ITERS},
         "bsr jacobi")
    jn = pipecg(L, bl, options=SolverOptions(engine="naive", M="jacobi",
                                             maxiter=CHECK_ITERS))
    gap = hist_close(jn.res_history, jac.res_history)
    say("bsr", check="lap2d-bsr4 jacobi fused vs naive", n=L.n,
        deg=L.max_deg, max_rel_gap=f"{gap:.3e}",
        ms_per_iter=f"{dt / CHECK_ITERS * 1e3:.4f}")

    multi, dt, counts = run(lambda: pipecg_multi(B, BB, maxiter=CHECK_ITERS,
                                                 engine="fused"))
    only(counts, {"spmv_bsr": 2, "pipecg_bsr_fused": CHECK_ITERS},
         "bsr pipecg_multi: one sweep per iteration for all 8 systems")
    gaps = [hist_close(pipecg(B, BB[j], options=fused(
        maxiter=CHECK_ITERS)).res_history, multi.res_history[j], rtol=1e-12)
        for j in range(8)]
    say("bsr", check="pipecg_multi k=8 vs 8 single solves",
        max_rel_gap=f"{max(gaps):.3e}",
        ms_per_iter=f"{dt / CHECK_ITERS * 1e3:.4f}")

    pcr, _, counts = run(lambda: pipecr(B, b, options=fused(
        maxiter=CHECK_ITERS)))
    only(counts, {"spmv_bsr": 2, "pipecg_bsr_fused": CHECK_ITERS},
         "bsr pipecr")
    pcrn = pipecr(B, b, options=SolverOptions(engine="naive",
                                              maxiter=CHECK_ITERS))
    gap = hist_close(pcrn.res_history, pcr.res_history)
    say("bsr", check="pipecr fused vs naive", max_rel_gap=f"{gap:.3e}")

    cb, dt, counts = run(lambda: pipecg(B, b, options=fused(
        maxiter=cb_iters, M=half)))
    only(counts, {"pipecg_fused": cb_iters, "spmv_bsr": cb_iters + 3},
         "bsr callable-M fallback")
    cbn = pipecg(B, b, options=SolverOptions(engine="naive",
                                             maxiter=cb_iters, M=half))
    gap = hist_close(cbn.res_history, cb.res_history)
    say("bsr", check="callable-M fallback vs naive", max_rel_gap=f"{gap:.3e}",
        launches=json.dumps(counts, separators=(",", ":")),
        ms_per_iter=f"{dt / cb_iters * 1e3:.4f}")


def wall(per_rank, i: int) -> float:
    """Wall seconds of case i: the slowest rank's."""
    return max(outcomes[i]["seconds"] for outcomes in per_rank)


def phase_ranks(records):
    """ex23 on RANKS ranks of one group on this card, against one device.

    Every rank runs ``ranks.solve_cases`` (the launch counts are reset
    just before each solve and read just after it, in the rank); the
    one-device counterparts run here afterwards.
    """
    import torch
    from repro_torch.core.krylov import (SolverOptions, cg, dia_to_bsr,
                                         glen_law_band, laplacian_2d, pipecg,
                                         pipecg_multi, pipecr,
                                         tridiagonal_laplacian)
    from repro_torch.core.perfmodel import Exponential, asymptotic_speedup
    from repro_torch.distributed import ranks

    cpu = torch.Generator().manual_seed(2)
    A = tridiagonal_laplacian(N_EX23, device="cpu")
    b = torch.randn(N_EX23, generator=cpu, dtype=torch.float64)
    B = torch.randn((4, N_EX23), generator=cpu, dtype=torch.float64)
    A_cd, b_cd = convdiff(cpu)
    sharded = dict(engine="sharded_fused")
    it = CHECK_ITERS
    bicg = {
        "bicg": ("pipebicgstab", b_cd,
                 dict(sharded, maxiter=BICG_RANK_ITERS, M="jacobi"), None),
        "bicg tol": ("pipebicgstab", b_cd,
                     dict(sharded, maxiter=BICG_TOL_ITERS, tol=BICG_TOL,
                          M="jacobi"), None),
        "bicg inline": ("pipebicgstab", b_cd,
                        dict(maxiter=BICG_INLINE_ITERS), None),
    }
    cases = {
        "main": ("pipecg", b, dict(sharded, maxiter=MAXITER), None),
        "quiet": ("pipecg", b, dict(sharded, maxiter=it), None),
        "noisy": ("pipecg", b, dict(sharded, maxiter=it),
                  (Exponential(1.0), NOISE_SCALE, 0)),
        "pipecr": ("pipecr", b, dict(sharded, maxiter=it), None),
        "jacobi": ("pipecg", b, dict(sharded, maxiter=it, M="jacobi"), None),
        "multi": ("pipecg_multi", B, dict(sharded, maxiter=it), None),
        "cg inline": ("cg", b, dict(maxiter=it), None),
        "pipecg inline": ("pipecg", b, dict(maxiter=it), None),
        **bicg,
        # the inline route with the extended-x SpMV kernel on every rank
        "gmres inline kernel": ("gmres", b, dict(restart=GMRES_RESTART,
                                                 use_kernel=True), None),
        "pgmres inline kernel": ("pgmres", b, dict(restart=GMRES_RESTART,
                                                   use_kernel=True), None),
        "pipecg inline kernel": ("pipecg", b, dict(maxiter=it,
                                                   use_kernel=True), None),
    }
    A_glen = glen_law_band(N_EX23, device="cpu")
    depth = {
        "depth": ("pipecg_l", b, dict(sharded, maxiter=DEPTH_RANK_ITERS,
                                      l=2), None),
        "depth tol": ("pipecg_l", b_cd,
                      dict(sharded, maxiter=DEPTH_TOL_ITERS, l=2,
                           tol=DEPTH_TOL, M="jacobi"), None),
    }
    cases.update(depth)
    # the plain-torch geometry bodies: BSR on the chain, DIA on a grid
    A_bsr = dia_to_bsr(A, bs=BSR_BS)
    A_lap = laplacian_2d(NX_LAP, NX_LAP, device="cpu")
    b_lap = torch.randn(A_lap.n, generator=cpu, dtype=torch.float64)
    geometry = {
        "bsr": ("pipecg", b, dict(sharded, maxiter=GEOM_RANK_ITERS), None),
        "grid": ("pipecg", b_lap, dict(sharded, maxiter=GEOM_RANK_ITERS),
                 None),
        "grid jacobi": ("pipecg", b_lap, dict(sharded, M="jacobi",
                                              maxiter=GEOM_RANK_ITERS),
                        None),
    }
    cases.update(geometry)
    names = list(cases)
    ops_of = dict.fromkeys(bicg, A_cd)
    ops_of["depth tol"] = A_glen
    ops_of.update({"bsr": A_bsr, "grid": A_lap, "grid jacobi": A_lap})
    grids = {"grid": GRID, "grid jacobi": GRID}
    spec = [dict(solver=sv, A=ops_of.get(name, A), b=rhs, kw=kw,
                 noise=nz, grid=grids.get(name))
            for name, (sv, rhs, kw, nz) in cases.items()]
    backend = ranks.backend_for(RANKS, DEVICE)
    t0 = time.perf_counter()
    out = ranks.run(ranks.solve_cases, RANKS, spec, DEVICE, device=DEVICE)
    say("ranks", ranks=RANKS, backend=backend, cards=torch.cuda.device_count(),
        spawn_and_solves_s=f"{time.perf_counter() - t0:.1f}")
    # the 200-iteration solve on fewer ranks: what one rank alone costs
    few = {P: ranks.run(ranks.solve_cases, P, spec[1:2], DEVICE,
                        device=DEVICE) for P in (1, 2)}

    # the main paths' launches: the 5000-iterate PIPECG solve and the
    # p-BiCGStab solve, each summed over ranks
    ib = names.index("bicg")
    for name, i in (("pipecg_spmv_halo", 0), ("fused_dots", 0),
                    ("pipebicgstab_halo", ib),
                    ("ghost_chain_halo", names.index("depth"))):
        # added to what the one-device paths launched ([gmres]'s dots)
        records[name]["launches"] += sum(o[i]["launches"][name] for o in out)
        check(records[name]["launches"] > 0,
              f"{name} never launched on the rank path")
    for i, name in enumerate(names):
        summed = {k: sum(o[i]["launches"][k] for o in out)
                  for k in out[0][i]["launches"]}
        say("ranks", case=repr(name), launches_summed_over_ranks=json.dumps(
            summed, separators=(",", ":")))
    for rank, outcomes in enumerate(out):
        for name, o in zip(names, outcomes):
            if cases[name][2].get("engine"):
                check(o["order_ok"] is True,
                      f"rank {rank} {name}: split-phase or depth order "
                      "broken")
            check(o["launches"]["pipecg_spmv_fused"] == 0,
                  f"rank {rank} {name}: the one-device sweep ran")
            ref = out[0][names.index(name)]
            check(all(np.array_equal(o[k], ref[k]) for k in
                      ("x", "res_history", "iters")),
                  f"rank {rank} {name}: ranks disagree")
        main = outcomes[0]
        check(main["launches"]["pipecg_spmv_halo"] == MAXITER,
              f"rank {rank}: {main['launches']['pipecg_spmv_halo']} sweeps")
        check(main["launches"]["fused_dots"] == 3,
              f"rank {rank}: init multi-dots {main['launches']}")
    res = {name: out[0][i] for i, name in enumerate(names)}
    say("ranks", solve="pipecg sharded_fused", n=N_EX23, ranks=RANKS,
        maxiter=MAXITER, seconds=f"{wall(out, 0):.3f}",
        ms_per_iter=f"{wall(out, 0) / MAXITER * 1e3:.4f}",
        launches=json.dumps(out[0][0]["launches"], separators=(",", ":")),
        order="issue(i)<halo(i+1)<wait(i)<launch(i+1) on every rank")
    # host time per iteration between the recorded events, mean of ranks
    seg = {k: np.mean([o[0]["segments"][k] for o in out]) * 1e6
           for k in out[0][0]["segments"]}
    say("ranks", host_us_per_iter=" ".join(f"{k}={v:.1f}"
                                           for k, v in seg.items()))

    dev = torch.device(DEVICE)
    Ad, bd, Bd = (tridiagonal_laplacian(N_EX23, device=dev), b.to(dev),
                  B.to(dev))
    fused = lambda **kw: SolverOptions(engine="fused", **kw)  # noqa: E731
    one = pipecg(Ad, bd, options=fused(maxiter=MAXITER))
    h_main = torch.from_numpy(res["main"]["res_history"])
    gap = hist_close(one.res_history[:it], h_main[:it])
    full_gap = float(((h_main - one.res_history.cpu()).abs()
                      / one.res_history.cpu()).max())
    xs = torch.from_numpy(res["main"]["x"])
    x_gap = float((xs - one.x.cpu()).abs().max() / one.x.cpu().abs().max())
    check(x_gap <= 1e-8, f"gathered x off by {x_gap}")
    say("ranks", check="4 ranks vs one-device fused", iters=it,
        max_rel_gap=f"{gap:.3e}", all_iters_max_rel_gap=f"{full_gap:.3e}",
        x_rel_gap=f"{x_gap:.3e}")
    singles = {
        "pipecr": pipecr(Ad, bd, options=fused(maxiter=it)).res_history,
        "jacobi": pipecg(Ad, bd, options=fused(maxiter=it, M="jacobi")
                         ).res_history,
        "multi": pipecg_multi(Ad, Bd, maxiter=it, engine="fused"
                              ).res_history,
        "cg inline": cg(Ad, bd, options=SolverOptions(maxiter=it)
                        ).res_history,
        "pipecg inline": pipecg(Ad, bd, options=SolverOptions(maxiter=it)
                                ).res_history,
    }
    for name, want in singles.items():
        gap = hist_close(want, torch.from_numpy(res[name]["res_history"]))
        say("ranks", check=f"{name} 4 ranks vs one device", iters=it,
            max_rel_gap=f"{gap:.3e}",
            ms_per_iter=f"{wall(out, names.index(name)) / it * 1e3:.4f}")
    for P, per_rank in few.items():
        gap = hist_close(one.res_history[:it],
                         torch.from_numpy(per_rank[0][0]["res_history"]))
        seg = " ".join(f"{k}={v * 1e6:.1f}"
                       for k, v in per_rank[0][0]["segments"].items())
        say("ranks", check=f"{P} rank(s) vs one device", iters=it,
            max_rel_gap=f"{gap:.3e}",
            ms_per_iter=f"{wall(per_rank, 0) / it * 1e3:.4f}",
            host_us_per_iter_rank0=seg)

    gmres_ranks(out, names, records, Ad, bd)
    bicg_ranks(out, names, records, A_cd, b_cd)
    depth_ranks(out, names, records, b, A_glen, b_cd)
    geometry_ranks(out, names, A_bsr, b, A_lap, b_lap)

    qi, ni = names.index("quiet"), names.index("noisy")
    for rank, outcomes in enumerate(out):
        q, nz = outcomes[qi], outcomes[ni]
        check(np.array_equal(q["res_history"], nz["res_history"])
              and np.array_equal(q["x"], nz["x"]),
              f"rank {rank}: noise changed the solve")
        draws = np.random.default_rng((0, rank)).exponential(
            1.0, size=it) * NOISE_SCALE
        check(np.array_equal(nz["waits"], draws),
              f"rank {rank}: waits are not the (0, {rank}) substream")
    quiet_s, noisy_s = wall(out, qi), wall(out, ni)
    mean_wait = np.mean([o[ni]["waits"].mean() for o in out])
    speedup = asymptotic_speedup(Exponential(1.0), RANKS)
    say("ranks", noise=f"Exponential(1) x {NOISE_SCALE} s", iters=it,
        history="bit-equal to quiet", quiet_s=f"{quiet_s:.4f}",
        noisy_s=f"{noisy_s:.4f}",
        added_us_per_iter=f"{(noisy_s - quiet_s) / it * 1e6:.1f}",
        mean_wait_per_rank_us=f"{mean_wait * 1e6:.1f}",
        asymptotic_speedup_P4=f"{speedup:.4f}")


def gmres_ranks(out, names, records, Ad, bd):
    """The inline route with ``use_kernel=True`` (``spmv_dia_ext`` on every
    rank) for gmres, pgmres and pipecg, against the one-device solves.

    Per rank: one extended-x SpMV a GMRES step plus the initial and final
    residuals (m + 2), PGMRES's m + 4; PGMRES's blocking all-reduces are
    ||r0||, two an iteration (line 16's norm, line 18's batch) and the
    final residual: 2 (m + 2) + 2.
    """
    import torch
    from repro_torch.core.krylov import SolverOptions, gmres, pgmres, pipecg
    m, it = GMRES_RESTART, CHECK_ITERS
    one = {"gmres inline kernel": gmres(Ad, bd, restart=m),
           "pgmres inline kernel": pgmres(Ad, bd, restart=m),
           "pipecg inline kernel": pipecg(Ad, bd,
                                          options=SolverOptions(maxiter=it))}
    spmvs = {"gmres inline kernel": m + 2, "pgmres inline kernel": m + 4}
    total = 0
    for name, want in one.items():
        i = names.index(name)
        for rank, outcomes in enumerate(out):
            o = outcomes[i]
            ext = o["launches"]["spmv_dia_ext"]
            check(ext > 0, f"rank {rank} {name}: no spmv_dia_ext launch")
            check(name not in spmvs or ext == spmvs[name],
                  f"rank {rank} {name}: {ext} extended SpMVs")
            check(o["launches"]["spmv_dia"] == 0,
                  f"rank {rank} {name}: the unpadded SpMV ran")
            total += ext
        got = out[0][i]
        if name == "pgmres inline kernel":
            check(all(o[i]["all_reduces"] == 2 * (m + 2) + 2 for o in out),
                  f"pgmres all-reduces {[o[i]['all_reduces'] for o in out]}")
        gap = hist_close(want.res_history,
                         torch.from_numpy(got["res_history"]))
        xs = torch.from_numpy(got["x"])
        x_gap = float((xs - want.x.cpu()).abs().max()
                      / want.x.cpu().abs().max())
        check(x_gap <= 1e-8, f"{name}: gathered x off by {x_gap}")
        steps = got["res_history"].shape[-1]
        say("ranks", check=f"{name} 4 ranks vs one device", steps=steps,
            max_rel_gap=f"{gap:.3e}", x_rel_gap=f"{x_gap:.3e}",
            spmv_dia_ext_per_rank=got["launches"]["spmv_dia_ext"],
            blocking_all_reduces_per_rank=got["all_reduces"],
            ms_per_step=f"{wall(out, i) / steps * 1e3:.4f}")
    records["spmv_dia_ext"]["launches"] = total


def bicg_ranks(out, names, records, A_cd, b_cd):
    """The p-BiCGStab rank cases against their one-device counterparts."""
    import torch
    from repro_torch.core.krylov import SolverOptions, pipebicgstab
    ib, it_, il = (names.index(k) for k in ("bicg", "bicg tol",
                                            "bicg inline"))
    check(records["pipebicgstab_halo"]["launches"]
          == RANKS * BICG_RANK_ITERS,
          f"pipebicgstab_halo: {records['pipebicgstab_halo']['launches']}")
    for rank, outcomes in enumerate(out):
        for i in (ib, it_):
            check(outcomes[i]["all_reduces"] == 1,
                  f"rank {rank}: blocking all-reduces in the sharded body")
            check(outcomes[i]["launches"]["pipebicgstab_fused"] == 0,
                  f"rank {rank}: the one-device p-BiCGStab sweep ran")
        check(outcomes[il]["all_reduces"] == BICG_INLINE_ITERS + 2,
              f"rank {rank}: inline p-BiCGStab issued "
              f"{outcomes[il]['all_reduces']} all-reduces")
    from repro_torch.core.krylov import convection_diffusion
    dev = torch.device(DEVICE)
    Ad, bd = convection_diffusion(N_EX23, device=dev), b_cd.to(dev)

    def one(**kw):
        return pipebicgstab(Ad, bd, options=SolverOptions(**kw))

    ref = one(engine="fused", M="jacobi", maxiter=BICG_RANK_ITERS)
    got = out[0][ib]
    h = torch.from_numpy(got["res_history"])
    gap = hist_close(ref.res_history[:BICG_CHECK], h[:BICG_CHECK])
    check(bool(torch.isfinite(h).all()), "non-finite rank history")
    xs = torch.from_numpy(got["x"]).to(dev)
    check(bool(torch.isfinite(xs).all()), "non-finite rank x")
    # past convergence forced iterates drift from their recurrence (H8,
    # BICG_DRIFT_MAX), so x is compared on the tol solve below
    bn = float(torch.linalg.norm(bd))
    true_rank = float(torch.linalg.norm(bd - Ad.matvec(xs))) / bn
    true_one = float(torch.linalg.norm(bd - Ad.matvec(ref.x))) / bn
    check(float(h[-1]) / bn < BICG_REC_MAX,
          f"rank recurrence residual {float(h[-1]) / bn}")
    check(max(true_rank, true_one) < BICG_DRIFT_MAX,
          f"forced x's true residuals {true_rank}, {true_one}")
    seg = {k: np.mean([o[ib]["segments"][k] for o in out]) * 1e6
           for k in got["segments"]}
    say("ranks", solve="pipebicgstab sharded_fused jacobi", n=N_EX23,
        ranks=RANKS, maxiter=BICG_RANK_ITERS,
        seconds=f"{wall(out, ib):.3f}",
        ms_per_iter=f"{wall(out, ib) / BICG_RANK_ITERS * 1e3:.4f}",
        launches_summed=records["pipebicgstab_halo"]["launches"],
        max_rel_gap_first_20=f"{gap:.3e}",
        true_rel_res_ranks=f"{true_rank:.3e}",
        true_rel_res_one_device=f"{true_one:.3e}",
        order="issue(i)<halo(i+1)<wait(i)<launch(i+1) on every rank")
    say("ranks", bicg_host_us_per_iter=" ".join(f"{k}={v:.1f}"
                                                for k, v in seg.items()))
    tol_one = one(engine="fused", M="jacobi", maxiter=BICG_TOL_ITERS,
                  tol=BICG_TOL)
    check(int(out[0][it_]["iters"]) == int(tol_one.iters) < BICG_TOL_ITERS,
          f"tol iters {int(out[0][it_]['iters'])} vs {int(tol_one.iters)}")
    xt = torch.from_numpy(out[0][it_]["x"])
    x_gap = float((xt - tol_one.x.cpu()).abs().max()
                  / tol_one.x.cpu().abs().max())
    check(x_gap <= 1e-8, f"gathered p-BiCGStab x off by {x_gap}")
    inline = one(maxiter=BICG_INLINE_ITERS)
    gap_i = hist_close(inline.res_history[:BICG_CHECK],
                       torch.from_numpy(out[0][il]["res_history"])
                       [:BICG_CHECK])
    say("ranks", check="p-BiCGStab tol and inline vs one device",
        tol_iters=int(tol_one.iters), tol_x_rel_gap=f"{x_gap:.3e}",
        inline_iters=BICG_INLINE_ITERS,
        inline_max_rel_gap=f"{gap_i:.3e}",
        inline_all_reduces_per_rank=out[0][il]["all_reduces"],
        inline_ms_per_iter=f"{wall(out, il) / BICG_INLINE_ITERS * 1e3:.4f}")


def depth_ranks(out, names, records, b, A_glen, b_glen):
    """The depth-l rank cases against their one-device counterparts."""
    import torch
    from repro_torch.core.krylov import (DiaMatrix, SolverOptions, pipecg_l,
                                         tridiagonal_laplacian)
    i_d, i_t = names.index("depth"), names.index("depth tol")
    blocks = -(-DEPTH_RANK_ITERS // 2)
    check(records["ghost_chain_halo"]["launches"] == RANKS * blocks,
          f"ghost_chain_halo: {records['ghost_chain_halo']['launches']}")
    for rank, outcomes in enumerate(out):
        for i in (i_d, i_t):
            o = outcomes[i]
            check(o["reductions"] == -(-o["res_history"].shape[-1] // 2),
                  f"rank {rank}: {o['reductions']} reductions, not one "
                  "per block")
            check(o["all_reduces"] == 3,
                  f"rank {rank}: {o['all_reduces']} blocking all-reduces")
            check(o["launches"]["ghost_chain_fused"] == 0,
                  f"rank {rank}: the one-device chain sweep ran")
    dev = torch.device(DEVICE)
    Ad, bd = tridiagonal_laplacian(N_EX23, device=dev), b.to(dev)
    it = 2 * DEPTH_CHECK_BLOCKS
    one = pipecg_l(Ad, bd, options=SolverOptions(engine="fused", maxiter=it,
                                                 depth=2))
    got = out[0][i_d]
    h = torch.from_numpy(got["res_history"])
    check(bool(torch.isfinite(h).all()), "non-finite depth rank history")
    gap = hist_close(one.res_history, h[:it])
    seg = {k: np.mean([o[i_d]["segments"][k] for o in out]) * 1e6
           for k in got["segments"]}
    say("ranks", solve="pipecg_l sharded_fused l=2", n=N_EX23, ranks=RANKS,
        maxiter=DEPTH_RANK_ITERS, seconds=f"{wall(out, i_d):.3f}",
        ms_per_iter=f"{wall(out, i_d) / DEPTH_RANK_ITERS * 1e3:.4f}",
        launches_summed=records["ghost_chain_halo"]["launches"],
        reductions_per_rank=got["reductions"],
        blocking_all_reduces_per_rank=got["all_reduces"],
        max_rel_gap_first_blocks=f"{gap:.3e}",
        order="halo(b)<launch(b)<issue(b)<wait(b)<halo(b+1) on every rank")
    say("ranks", depth_host_us_per_iter=" ".join(
        f"{k}={v:.1f}" for k, v in seg.items()))
    Ag = DiaMatrix(offsets=A_glen.offsets, bands=A_glen.bands.to(dev))
    tol_one = pipecg_l(Ag, b_glen.to(dev), options=SolverOptions(
        engine="fused", maxiter=DEPTH_TOL_ITERS, depth=2, tol=DEPTH_TOL,
        M="jacobi"))
    got = out[0][i_t]
    check(int(got["iters"]) == int(tol_one.iters) < DEPTH_TOL_ITERS,
          f"depth tol iters {int(got['iters'])} vs {int(tol_one.iters)}")
    xt = torch.from_numpy(got["x"])
    x_gap = float((xt - tol_one.x.cpu()).abs().max()
                  / tol_one.x.cpu().abs().max())
    check(x_gap <= 1e-8, f"gathered depth x off by {x_gap}")
    bn = float(torch.linalg.norm(b_glen))
    true_res = float(torch.linalg.norm(b_glen - A_glen.matvec(xt))) / bn
    say("ranks", check="pipecg_l tol on glen (21 bands), jacobi, 4 ranks vs "
        "one device", iters=int(tol_one.iters), x_rel_gap=f"{x_gap:.3e}",
        true_rel_res=f"{true_res:.3e}",
        ms_per_iter=f"{wall(out, i_t) / max(int(got['iters']), 1) * 1e3:.4f}")


def geometry_ranks(out, names, A_bsr, b, A_lap, b_lap):
    """The BSR-chain and (2, 2)-grid rank cases against one device."""
    import torch
    from repro_torch.core.krylov import (BsrMatrix, DiaMatrix, SolverOptions,
                                         pipecg)
    dev = torch.device(DEVICE)
    Bd = BsrMatrix(indices=A_bsr.indices.to(dev),
                   blocks=A_bsr.blocks.to(dev))
    Ld = DiaMatrix(offsets=A_lap.offsets, bands=A_lap.bands.to(dev),
                   grid_shape=A_lap.grid_shape)
    for name, Ad, rhs, M, layout in (
            ("bsr", Bd, b, None, f"chain of {RANKS} ranks"),
            ("grid", Ld, b_lap, None, f"{GRID} grid"),
            ("grid jacobi", Ld, b_lap, "jacobi", f"{GRID} grid")):
        i = names.index(name)
        for rank, outcomes in enumerate(out):
            o = outcomes[i]
            check(o["reductions"] == GEOM_RANK_ITERS + 1,
                  f"rank {rank} {name}: {o['reductions']} reductions, not "
                  "one per iteration")
            check(o["all_reduces"] == 1,
                  f"rank {rank} {name}: {o['all_reduces']} blocking "
                  "all-reduces")
            check(sum(o["launches"].values()) == 0,
                  f"rank {rank} {name}: the plain-torch body launched "
                  f"{o['launches']}")
        got = out[0][i]
        h = torch.from_numpy(got["res_history"])
        check(bool(torch.isfinite(h).all())
              and bool(np.isfinite(got["x"]).all()),
              f"non-finite {name} rank solve")
        one = pipecg(Ad, rhs.to(dev), options=SolverOptions(
            engine="fused", maxiter=GEOM_CHECK, M=M))
        gap = hist_close(one.res_history, h[:GEOM_CHECK])
        seg = {k: np.mean([o[i]["segments"][k] for o in out]) * 1e6
               for k in got["segments"]}
        say("ranks", solve=f"pipecg sharded_fused {name}", n=Ad.n,
            layout=layout, maxiter=GEOM_RANK_ITERS,
            seconds=f"{wall(out, i):.3f}",
            ms_per_iter=f"{wall(out, i) / GEOM_RANK_ITERS * 1e3:.4f}",
            reductions_per_rank=got["reductions"],
            max_rel_gap_first=f"{gap:.3e}",
            max_abs_detect=f"{float(np.abs(got['detect_history']).max()):.3e}",
            order="issue(i)<halo(i+1)<wait(i)<launch(i+1) on every rank")
        say("ranks", case=repr(name), host_us_per_iter=" ".join(
            f"{k}={v:.1f}" for k, v in seg.items()))


def wire_problems(n: int):
    """The precision stage's operators at ``n`` and their right-hand
    sides (numpy; rng(1) as the stage's seed + 1)."""
    import torch
    from repro_torch.core.krylov.operators import DiaMatrix
    i = np.arange(n)

    def band(offsets, diag):
        bands = np.stack([np.full(n, diag) if o == 0 else
                          np.where((i + o >= 0) & (i + o < n), -1.0, 0.0)
                          for o in offsets])
        return DiaMatrix(offsets=offsets, bands=torch.from_numpy(bands))

    return {"pipecg": (band((-128, -1, 0, 1, 128), 4.1), torch.from_numpy(
                np.random.default_rng(1).standard_normal(n))),
            "pipebicgstab": (band((-1, 0, 1), 3.0),
                             torch.ones(n, dtype=torch.float64))}


def phase_wire(records):
    """[wire]: the int8 halo/Gram wire on 4 ranks of this card.

    Every cell runs the sharded body (``ranks.solve_cases``) with the
    launch counts set to 0 just before it and read just after it.  Gates:
    the split-phase order and one reduction an iteration on every rank;
    the bytes each rank hands ``comm`` (int8 strips of 4 + 2h bytes under
    the wire, storage-dtype strips otherwise); the stage's classification
    of the PIPECG cells at its n = 1024 (safe within the floor, no-EF at
    least 1.05x EF, the int8 Gram outside), and at full size the safe and
    unsafe verdicts; finite p-BiCGStab results (the stage makes no floor
    claim for p-BiCGStab with the wire, so its plateaus are printed, and
    runs only at full size).  One spawn runs every cell.
    """
    import torch
    from repro_torch.core.krylov.hostops import true_residual_norm
    from repro_torch.core.krylov.options import PrecisionPolicy
    from repro_torch.distributed import ranks

    sizes = {WIRE_N: [(s, p) for s in WIRE_ITERS for p in WIRE_POLICIES],
             WIRE_STAGE_N: [("pipecg", p) for p in WIRE_POLICIES]}
    probs = {n: wire_problems(n) for n in sizes}
    keys = [(n, s, p) for n, cells in sizes.items() for s, p in cells]
    spec = [dict(solver=s, A=probs[n][s][0], b=probs[n][s][1],
                 kw=dict(engine="sharded_fused", maxiter=WIRE_ITERS[s],
                         precision=p)) for n, s, p in keys]
    t0 = time.perf_counter()
    out = ranks.run(ranks.solve_cases, RANKS, spec, DEVICE, device=DEVICE)
    say("wire", ranks=RANKS, backend=ranks.backend_for(RANKS, DEVICE),
        spawn_and_solves_s=f"{time.perf_counter() - t0:.1f}")
    for n, cells in sizes.items():
        plateau = {}
        for solver, policy in cells:
            i = keys.index((n, solver, policy))
            A, b = probs[n][solver]
            h = max(abs(o) for o in A.offsets)
            it = WIRE_ITERS[solver]
            pol = PrecisionPolicy.from_name(policy)
            kernel = ("pipecg_spmv_halo" if solver == "pipecg"
                      else "pipebicgstab_halo")
            nvec = 2 if solver == "pipecg" else 3
            for rank, o in enumerate(out):
                oc = o[i]
                check(oc["order_ok"] is True and oc["reductions"] == it + 1,
                      f"[wire] {solver}/{policy} rank {rank}: split-phase "
                      "order broken")
                check(oc["launches"][kernel] == it,
                      f"[wire] {solver}/{policy} rank {rank}: "
                      f"{oc['launches'][kernel]} sweeps")
                check(np.all(np.isfinite(oc["x"])),
                      f"[wire] {solver}/{policy} rank {rank}: x not finite")
                strips = it * nvec * ((rank > 0) + (rank < RANKS - 1))
                key = ("int8" if pol.wire == "int8" else "bfloat16"
                       if pol.storage == "bf16" else "float64")
                per = ((4 + 2 * h) if key == "int8" else 2 * h * (
                    2 if key == "bfloat16" else 8))
                got = oc["wire_bytes"].get(key, 0)
                if key == "float64":   # the set-up's exchanges ride too
                    got -= (len(A.offsets) + 2) * h * 8 * (
                        (rank > 0) + (rank < RANKS - 1))
                check(got == strips * per,
                      f"[wire] {solver}/{policy} rank {rank}: "
                      f"{oc['wire_bytes']} on the wire")
                if pol.wire == "int8":
                    check("bfloat16" not in oc["wire_bytes"],
                          f"[wire] {solver}/{policy}: a full-width strip")
            for k in (kernel, "fused_dots"):
                records[k]["launches"] += sum(o[i]["launches"][k]
                                              for o in out)
            eps = pol.storage_eps
            rel = true_residual_norm(A, b, out[0][i]["x"]) / float(
                torch.linalg.norm(b))
            plateau[(solver, policy)] = rel / eps
            seg = out[0][i]["segments"]
            say("wire", n=n, solver=solver, policy=policy,
                plateau_eps=f"{rel / eps:.4f}", true_res_rel=f"{rel:.3e}",
                floor_eps=WIRE_FLOOR[solver],
                ms_per_iter=f"{wall(out, i) / it * 1e3:.4f}",
                strip_bytes=per,
                host_us_per_iter=" ".join(f"{k}={v * 1e6:.1f}"
                                          for k, v in seg.items()))
        noef = (plateau[("pipecg", "bf16_int8wire_noef")]
                / plateau[("pipecg", "bf16_int8wire")])
        say("wire", n=n, noef_over_ef=f"{noef:.4f}",
            min_ratio=WIRE_NOEF_RATIO)
        for policy in ("fp32", "bf16", "bf16_int8wire"):
            check(plateau[("pipecg", policy)] <= WIRE_FLOOR["pipecg"],
                  f"[wire] n={n} pipecg {policy}: outside the floor")
        check(plateau[("pipecg", "bf16_int8allwire")] > WIRE_FLOOR["pipecg"],
              f"[wire] n={n}: the int8 Gram inside the floor")
        if n == WIRE_STAGE_N:
            check(plateau[("pipecg", "bf16_int8wire_noef")]
                  <= WIRE_FLOOR["pipecg"] and noef >= WIRE_NOEF_RATIO,
                  f"[wire] n={n}: no-EF not degraded ({noef:.4f})")


def checkpoint_save_ms(state, directory: str, dev):
    """One ``CheckpointManager.save`` of ``state`` as the resilient loop
    makes it: ms of the host copy the segment waits for, ms of the
    background write that ``wait()`` drains, and the bytes saved."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory, keep=1, async_write=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mgr.save(1, state)
    t1 = time.perf_counter()
    mgr.wait()
    t2 = time.perf_counter()
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, nbytes


def handoff_ranks(rank: int, world: int, A, b, device: str, save_dir: str):
    """Rank body of [resilient]'s carried hand-off: 10 iterations on every
    rank, the state handed to the first half, 30 more there, beside the
    straight 40 (distributed/fault.py's warm start).  Rank 0 also times a
    checkpoint save of the handed-off device state into ``save_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.krylov import distributed_solve, pipecg
    from repro_torch.core.krylov.operators import DiaMatrix

    dev = torch.device(device)
    A = DiaMatrix(offsets=A.offsets, bands=A.bands.to(dev))
    b = b.to(dev)
    kw = dict(engine="sharded_fused", tol=0.0)
    straight = distributed_solve(pipecg, A, b, maxiter=40, **kw)
    _, state = distributed_solve(pipecg, A, b, maxiter=10, with_state=True,
                                 **kw)
    save = checkpoint_save_ms(state, save_dir, dev) if rank == 0 else None
    half = dist.new_group(ranks=list(range(world // 2)))
    out = None
    if rank < world // 2:
        second = distributed_solve(pipecg, A, b, half, maxiter=30,
                                   carried=state, **kw)
        out = (second.x.cpu().numpy(), float(second.res_norm))
    dist.barrier()
    return dict(straight=(straight.x.cpu().numpy(),
                          float(straight.res_norm)), second=out, save=save)


def resilient_ranks(rank: int, world: int, spec, A, b, device: str,
                    save_dir: str):
    """Rank body of [resilient]: the resilient cases, then the hand-off."""
    from repro_torch.distributed import fault
    return (fault.resilient_cases(rank, world, spec, device),
            handoff_ranks(rank, world, A, b, device, save_dir))


def phase_resilient(records):
    """[resilient]: ``resilient_distributed_solve`` on 4 ranks of this card.

    Cases: undisturbed, kill:1@14, kill:1@14 + kill:3@26, corrupt:2@8,
    stall:0@5 (no ambient noise, 1 ms stalls: the detector reads recorded
    waits), and two rollbacks after a segment accepted without a rank,
    stall:0@5 + corrupt:2@25 and kill:1@14 + kill:3@32, each with the
    launch counts of its segments summed; then the carried hand-off 4 ->
    2.  Gates: tests/test_torch_fault.py's
    assertions (the double kill's true residual in relative form), and
    the overhead in iterations (executed minus undisturbed; a stall's
    ``detect_iters``) within 2x ``recovery_overhead_bound`` a fault.
    Prints segments, recoveries, ms a segment, a checkpoint save of the
    hand-off's device state as the loop makes it (the host copy a segment
    waits for, the background write apart) and
    ``optimal_checkpoint_period`` at the copy's cost.
    """
    import tempfile

    import torch
    from repro_torch.core.krylov import tridiagonal_laplacian
    from repro_torch.core.krylov.operators import DiaMatrix
    from repro_torch.core.perfmodel import (optimal_checkpoint_period,
                                            recovery_overhead_bound)
    from repro_torch.distributed import ranks

    T = tridiagonal_laplacian(RES_N, device="cpu")
    bands = T.bands.clone()
    bands[list(T.offsets).index(0)] += 1.0
    A = DiaMatrix(offsets=T.offsets, bands=bands)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(RES_N))
    norm_b = float(torch.linalg.norm(b))
    names = {"undisturbed": None, "kill": ["kill:1@14"],
             "double kill": ["kill:1@14", "kill:3@26"],
             "corrupt": ["corrupt:2@8"], "stall": ["stall:0@5"],
             "stall + corrupt": ["stall:0@5", "corrupt:2@25"],
             "late double kill": ["kill:1@14", "kill:3@32"]}
    with tempfile.TemporaryDirectory(prefix="resilient_") as tmp:
        spec = [dict(A=A, b=b, faults=f, seed=k,
                     fault_kw=dict(stall_s=1e-3) if "stall" in name else {},
                     kw=dict(tol=RES_TOL, maxiter=160,
                             checkpoint_period=RES_PERIOD,
                             ckpt_dir=f"{tmp}/{k}"))
                for k, (name, f) in enumerate(names.items())]
        t0 = time.perf_counter()
        both = ranks.run(resilient_ranks, RANKS, spec, A, b, DEVICE,
                         f"{tmp}/save", device=DEVICE)
        out, hand = [o for o, _ in both], [h for _, h in both]
        say("resilient", n=RES_N, ranks=RANKS,
            spawn_and_solves_s=f"{time.perf_counter() - t0:.1f}")
        reps = {name: out[0][k]["report"] for k, name in enumerate(names)}
        for k, name in enumerate(names):
            for rank in range(RANKS):
                check(out[rank][k]["report"] == reps[name],
                      f"[resilient] {name}: ranks disagree")
            rep = reps[name]
            segs = rep["segment_walls"]
            say("resilient", case=repr(name), converged=rep["converged"],
                segments=rep["segments"], executed=rep["executed_iters"],
                productive=rep["productive_iters"],
                shards_final=rep["n_shards_final"],
                true_res_rel=f"{rep['true_res_norm'] / norm_b:.3e}",
                ms_per_segment=f"{np.mean(segs) * 1e3:.1f}",
                wall_s=f"{rep['wall_s']:.3f}",
                recoveries=json.dumps([
                    {k2: e[k2] for k2 in ("kind", "shard", "segment",
                                          "detect_iters", "iters_lost",
                                          "mode", "detector")}
                    for e in rep["recoveries"]], separators=(",", ":")))
            check(rep["converged"], f"[resilient] {name}: not converged")
        rep0 = reps["undisturbed"]
        check(not rep0["recoveries"], "[resilient] undisturbed recovered")
        kill = reps["kill"]
        check(kill["n_shards_final"] == 3
              and [(e["kind"], e["mode"]) for e in kill["recoveries"]]
              == [("kill", "rollback_restart")]
              and kill["true_res_norm"] <= 10 * max(
                  rep0["true_res_norm"], 1e-12),
              "[resilient] kill:1@14 not recovered as the reference does")
        dk = reps["double kill"]
        check(dk["n_shards_final"] == 2
              and sorted(e["kind"] for e in dk["recoveries"])
              == ["kill", "kill"] and dk["true_res_norm"] < 1e-8 * norm_b,
              "[resilient] the double kill not recovered")
        cr = reps["corrupt"]
        check([(e["kind"], e["mode"]) for e in cr["recoveries"]]
              == [("corrupt", "rollback_restart")]
              and cr["recoveries"][0]["detector"] in ("checksum",
                                                      "history_jump")
              and cr["executed_iters"] > rep0["executed_iters"],
              "[resilient] corrupt:2@8 not rolled back")
        st = reps["stall"]
        check([(e["kind"], e["mode"], e["shard"]) for e in st["recoveries"]]
              == [("stall", "evict_continue", 0)]
              and st["n_shards_final"] == 3,
              "[resilient] stall:0@5 not evicted")
        # rollbacks after a segment accepted without a rank
        sc = reps["stall + corrupt"]
        check([(e["kind"], e["shard"]) for e in sc["recoveries"]]
              == [("stall", 0), ("corrupt", 2)]
              and sc["n_shards_final"] == 3,
              "[resilient] stall:0@5 + corrupt:2@25 not recovered")
        lk = reps["late double kill"]
        check([(e["kind"], e["shard"]) for e in lk["recoveries"]]
              == [("kill", 1), ("kill", 3)] and lk["n_shards_final"] == 2
              and lk["true_res_norm"] < 1e-8 * norm_b,
              "[resilient] kill:1@14 + kill:3@32 not recovered")
        for name in list(names)[1:]:
            rep = reps[name]
            kinds = [e["kind"] for e in rep["recoveries"]]
            bound_iters = sum(recovery_overhead_bound(k, RES_PERIOD)
                              for k in kinds)
            over = (rep["recoveries"][0]["detect_iters"] if name == "stall"
                    else rep["executed_iters"] - rep0["executed_iters"])
            say("resilient", case=repr(name), overhead_iters=over,
                bound_iters=bound_iters,
                ratio=f"{over / bound_iters:.3f}")
            check(over <= RES_OVERHEAD_FACTOR * bound_iters,
                  f"[resilient] {name}: overhead {over} > 2x {bound_iters}")
        for kernel in ("pipecg_spmv_halo", "fused_dots"):
            records[kernel]["launches"] += sum(
                sum(o[k]["launches"][kernel] for k in range(len(names)))
                for o in out)
    copy_ms, write_ms, save_bytes = hand[0]["save"]
    seg_ms = np.mean(reps["undisturbed"]["segment_walls"]) * 1e3
    cost_iters = copy_ms / (seg_ms / RES_PERIOD)
    say("resilient", checkpoint_copy_ms=f"{copy_ms:.1f}",
        checkpoint_write_ms=f"{write_ms:.1f}", bytes=save_bytes,
        ms_per_iter=f"{seg_ms / RES_PERIOD:.3f}",
        save_cost_iters=f"{cost_iters:.2f}",
        optimal_period_at_fault_rate=" ".join(
            f"{lam:g}:{optimal_checkpoint_period(cost_iters, lam):.1f}"
            for lam in (1e-3, 1e-4)))
    xs, rs = hand[0]["straight"]
    x2, r2 = hand[0]["second"]
    gap = float(np.linalg.norm(x2 - xs) / np.linalg.norm(xs))
    say("resilient", case="'carried 4 -> 2'", iters="10+30",
        x_rel_gap=f"{gap:.3e}", res_gap=f"{abs(r2 - rs):.3e}")
    check(gap < 1e-10 and abs(r2 - rs) < 1e-10 * max(rs, 1.0),
          "[resilient] the carried hand-off differs from the straight solve")


def phase_wkv_entry(records):
    """``ops.wkv_recurrent``, the kernel's entry (no model path calls it:
    the JAX package's RWKV blocks use a chunked jnp form), once at
    rwkv6-7b's shape with the counts set to 0 just before and read just
    after."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv import wkv_recurrent_plain
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    BH, T, D = WKV_SHAPE
    r, k, v = (torch.randn(WKV_SHAPE, generator=gen, device=DEVICE)
               for _ in range(3))
    logw = -torch.exp(torch.randn(WKV_SHAPE, generator=gen, device=DEVICE)
                      - 2.0)
    u = 0.3 * torch.randn((BH, D), generator=gen, device=DEVICE)
    ops.reset_launch_counts()
    o = ops.wkv_recurrent(r, k, v, logw, u)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["wkv_recurrent"] == 1 and sum(counts.values()) == 1,
          f"wkv entry launches {counts}")
    records["wkv_recurrent"]["launches"] = counts["wkv_recurrent"]
    want = wkv_recurrent_plain(r, k, v, logw, u)
    err = max_err([o], [want])
    check(err <= WKV_REL_TOL * float(want.abs().max()), f"wkv entry {err}")
    say("wkv", entry="ops.wkv_recurrent", shape="x".join(map(str, WKV_SHAPE)),
        launches=counts["wkv_recurrent"], max_abs_err=f"{err:.3e}")


def phase_serve(records):
    """LM serving of qwen3-1.7b at full width (28 layers, d_model 2048,
    random weights from seed 0): ``launch.serve.serve`` with
    ``attn_kernel=True``, batch 4, prompt 2048, 32 greedy decode steps,
    the counts set to 0 just before it and read just after it (one flash
    launch per layer in prefill, none in decode); its prefill logits held
    to the dense route's on the same weights and prompt, and its second
    token to a prefill over prompt + first token."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prompt_tokens, serve
    from repro_torch.models import init_params, prefill

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_kernel=True)
    plain = dataclasses.replace(cfg, attn_kernel=False)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}",
        params=n_params, param_gb=f"{n_params * 4 / 1e9:.3f}",
        init_seconds=f"{time.perf_counter() - t0:.2f}")
    # a short warm-up run, so cuBLAS has its plans before the timed one
    serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, decode_steps=2,
          device=dev, params=params, progress=lambda line: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    out = serve(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                decode_steps=SERVE_STEPS, device=dev, params=params,
                progress=print)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_flash = counts["flash_attention"]
    say("serve", launches=json.dumps(counts, separators=(",", ":")))
    check(out["launches"]["prefill"]["flash_attention"] == cfg.num_layers,
          f"prefill flash launches {out['launches']['prefill']}")
    check(out["launches"]["decode"]["flash_attention"] == 0,
          f"decode launched flash {out['launches']['decode']}")
    check(n_flash == cfg.num_layers and sum(counts.values()) == n_flash,
          f"serve launches {counts}")
    records["flash_attention"]["launches"] = n_flash
    toks = out["tokens"]
    check(tuple(toks.shape) == (SERVE_BATCH, SERVE_STEPS),
          f"tokens {tuple(toks.shape)}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "token ids out of range")
    logits = out["logits"].float()
    check(tuple(logits.shape) == (SERVE_BATCH, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    lat = out["step_latency"]
    check(lat["n"] == SERVE_STEPS - 1, f"latency samples {lat['n']}")

    prompt = prompt_tokens(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, _ = prefill(params, plain, {"tokens": prompt})
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        lp = lp.float()
        ext = torch.cat([prompt, toks[:, :1]], dim=1)
        l2, _ = prefill(params, plain, {"tokens": ext})
    gap = float((logits - lp).abs().max())
    agree = float((logits.argmax(-1) == lp.argmax(-1)).float().mean())
    check(gap <= LOGIT_TOL and agree >= ARGMAX_AGREE,
          f"kernel vs dense prefill logits: gap {gap}, argmax {agree}")
    agree2 = float((l2[:, -1].float().argmax(-1) == toks[:, 1]).float()
                   .mean())
    check(agree2 >= ARGMAX_AGREE,
          f"second token vs prefill over prompt + first: {agree2}")
    flash_ms = records["flash_attention"]["ms"]
    share = cfg.num_layers * flash_ms / (out["t_prefill"] * 1e3)
    say("serve", batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
        decode_steps=SERVE_STEPS,
        prefill_ms=f"{out['t_prefill'] * 1e3:.3f}",
        dense_prefill_ms=f"{plain_s * 1e3:.3f}",
        decode_p50_ms=f"{lat['p50'] * 1e3:.3f}",
        decode_p99_ms=f"{lat['p99'] * 1e3:.3f}",
        decode_mean_ms=f"{lat['mean'] * 1e3:.3f}",
        peak_memory_gb=f"{peak / 1e9:.3f}",
        flash_ms_per_launch=f"{flash_ms:.4f}",
        flash_share_of_prefill=f"{share:.3f}")
    say("serve", check="kernel vs dense prefill logits",
        max_abs_gap=f"{gap:.4f}", argmax_agree=f"{agree:.2f}",
        second_token_vs_prefill=f"{agree2:.2f}")


def serve_mode_minima(n: int, count: int, modes, seed: int):
    """Each request's smallest excited mode: the host draws of
    ``serve.load.synthetic_requests`` replayed (mode count, mode indices,
    one coefficient a mode, in that order)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        m = int(rng.integers(modes[0], modes[1] + 1))
        js = rng.choice(n, size=m, replace=False) + 1
        for _ in js:
            rng.standard_normal()
        out.append(int(js.min()))
    return out


def serve_run_checks(name: str, counts: dict, step_block: int) -> None:
    """One server run's launches against its own bookkeeping: a sweep a
    batch iteration, two SpMVs a batcher init or admission (restarts are
    admissions), nothing else; and no detection outside the chaos run."""
    sweeps = counts["launches"]["pipecg_spmv_fused"]
    spmvs = counts["launches"]["spmv_dia"]
    check(sweeps == step_block * counts["blocks"],
          f"{name}: {sweeps} sweeps for {counts['blocks']} blocks")
    check(spmvs == 2 * (counts["batcher_inits"] + counts["admissions"]),
          f"{name}: {spmvs} SpMVs for {counts['admissions']} admissions")
    check(sum(counts["launches"].values()) == sweeps + spmvs,
          f"{name}: other kernels {counts['launches']}")


def serve_converged(name: str, records, reqs) -> list:
    """Every request retired once, and each either converged (true
    residual within 1.01 tol ||b||: the server's host exit check, re-read
    here) or ran its whole iteration budget and is reported not converged
    with a finite true residual above that (ROADMAP H14: at n = 2^21 some
    of the workload's requests need more than maxiter 600 iterations, in
    the JAX package too).  Returns the ids of the latter."""
    import math
    import torch
    check(sorted(r.rid for r in records) == sorted(q.rid for q in reqs),
          f"{name}: records {len(records)} for {len(reqs)} requests")
    by_rid = {q.rid: q for q in reqs}
    capped = []
    for rec in records:
        req = by_rid[rec.rid]
        bn = float(torch.linalg.vector_norm(torch.as_tensor(req.b).double()))
        bar = 1.01 * req.tol * bn
        if rec.converged and rec.res_norm <= bar:
            continue
        check(not rec.converged and rec.iters == req.maxiter
              and math.isfinite(rec.res_norm) and rec.res_norm > bar,
              f"{name}: request {rec.rid} res {rec.res_norm:.3e} after "
              f"{rec.iters} iterations, {rec.restarts} restarts")
        capped.append(rec.rid)
    return sorted(capped)


def phase_solve_serve(records):
    """Solver serving at ex23's n = 2,097,152 (float64, the fused engine):
    ``run_serve_exec`` with the JAX package's serve workload (burst:
    batched k = 8 against a k = 1 sequential server; accuracy: 4 requests
    served solo at k = 8 against their batched records, iterations equal
    and x bit for bit; paced: rho 0.7 Poisson arrivals at the burst's
    measured rate, the 16,384-request replay and the M/G/k quantiles),
    then a ``SolverServer`` over 16 trace-paced requests under the
    reference's chaos lane.  The counts are set to 0 just before and
    read just after; each run's launches are held to its blocks and
    admissions."""
    import dataclasses
    import torch
    from repro_torch.experiments import get_preset
    from repro_torch.experiments.serve_exec import (bench_record, jsonable,
                                                    run_serve_exec)
    from repro_torch.kernels import ops
    from repro_torch.serve import (ServeChaos, SolverServer, arrival_times,
                                   synthetic_requests)

    t_phase = time.perf_counter()
    spec = dataclasses.replace(get_preset("smoke"), serve_n=N_EX23)
    B, k = spec.serve_step_block, spec.serve_k_slots
    check(spec.serve_engine == "fused", f"serve engine {spec.serve_engine}")
    say("solve_serve", n=spec.serve_n, requests=spec.serve_requests,
        k_slots=k, step_block=B, modes=spec.serve_modes, tol=spec.serve_tol,
        maxiter=spec.serve_maxiter, rho=spec.serve_rho,
        replay=spec.serve_replay_requests, engine=spec.serve_engine,
        state_gb=f"{4 * k * spec.serve_n * 8 / 1e9:.3f}")
    ops.reset_launch_counts()
    serve = run_serve_exec(spec, device=DEVICE)
    kept = serve["_servers"]
    A = next(iter(kept["batched"].batchers.values())).A
    lam = serve["paced"]["lam"]
    reqs = synthetic_requests(
        A, SOLVE_SERVE_CHAOS_REQUESTS, tol=spec.serve_tol,
        maxiter=spec.serve_maxiter, modes=spec.serve_modes,
        arrival=arrival_times("trace:PIPECG", SOLVE_SERVE_CHAOS_REQUESTS,
                              lam, seed=spec.seed + 11, device=DEVICE),
        seed=spec.seed + 11)
    chaos = ServeChaos(list(SOLVE_SERVE_CHAOS))
    csrv = SolverServer(k_slots=k, step_block=B, chaos=chaos)
    csrv.warmup(reqs[0])
    csrv.submit_all(reqs)
    cstats = csrv.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    seconds = time.perf_counter() - t_phase

    burst, paced = serve["burst"], serve["paced"]
    runs = {"burst_batched": burst["run_counts"]["batched"],
            "burst_sequential": burst["run_counts"]["sequential"],
            "paced": paced["run_counts"], "chaos": csrv.run_counts}
    runs.update({f"solo_{c['rid']}": c["run_counts"]
                 for c in serve["accuracy"]})
    # every server of the phase paid one warmup outside its run: a batcher
    # init and an admission (4 SpMVs) and one block
    warmups = len(runs)
    for name, rc in runs.items():
        serve_run_checks(name, rc, B)
        if name != "chaos":
            check(rc["detections"] == 0 and rc["restarts"] == 0,
                  f"{name}: a clean run reported {rc['detections']} "
                  f"detections, {rc['restarts']} restarts")
    sweeps = sum(rc["blocks"] for rc in runs.values()) * B + warmups * B
    spmvs = sum(2 * (rc["batcher_inits"] + rc["admissions"])
                for rc in runs.values()) + 4 * warmups
    say("solve_serve", launches=json.dumps(counts, separators=(",", ":")),
        runs=len(runs), sweeps_expected=sweeps, spmvs_expected=spmvs)
    check(counts["pipecg_spmv_fused"] == sweeps
          and counts["spmv_dia"] == spmvs
          and sum(counts.values()) == sweeps + spmvs,
          f"[solve_serve] launches {counts}")
    for name in ("pipecg_spmv_fused", "spmv_dia"):
        records[name]["launches"] += counts[name]

    b, s = burst["batched"], burst["sequential"]
    minima = serve_mode_minima(spec.serve_n, spec.serve_requests,
                               spec.serve_modes, spec.seed)
    by_rid = {r.rid: r for r in kept["batched"].records}
    say("solve_serve", requests="rid:min_mode:iters:restarts:true_res",
        burst=" ".join(f"{i}:{j}:{by_rid[i].iters}:{by_rid[i].restarts}:"
                       f"{by_rid[i].res_norm:.3e}"
                       for i, j in enumerate(minima)))
    pminima = serve_mode_minima(spec.serve_n, spec.serve_requests,
                                spec.serve_modes, spec.seed + 2)
    by_rid = {r.rid: r for r in kept["paced"].records}
    say("solve_serve", requests="rid:min_mode:iters:restarts:true_res",
        paced=" ".join(f"{i}:{j}:{by_rid[i].iters}:{by_rid[i].restarts}:"
                       f"{by_rid[i].res_norm:.3e}"
                       for i, j in enumerate(pminima)))
    capped = {
        "burst batched": serve_converged("burst batched",
                                         kept["batched"].records,
                                         kept["burst_requests"]),
        "burst sequential": serve_converged("burst sequential",
                                            kept["sequential"].records,
                                            kept["burst_requests"]),
        "paced": serve_converged("paced", kept["paced"].records,
                                 kept["paced_requests"])}
    for name, st in (("burst batched", b), ("burst sequential", s),
                     ("paced", paced["wall"])):
        check(st["drained"] and st["n_converged"] + len(capped[name])
              == st["n_requests"],
              f"{name}: drained {st['drained']}, converged "
              f"{st['n_converged']} of {st['n_requests']}")
    check(capped["burst batched"] == capped["burst sequential"],
          f"capped requests differ between k = {k} and k = 1: {capped}")
    blocks = runs["burst_batched"]["blocks"]
    seq_blocks = runs["burst_sequential"]["blocks"]
    ms_block = b["wall_s"] / blocks * 1e3
    seq_ms_block = s["wall_s"] / seq_blocks * 1e3
    say("solve_serve", stage="burst",
        batched_rps=f"{b['throughput_rps']:.4f}",
        sequential_rps=f"{s['throughput_rps']:.4f}",
        ratio=f"{burst['throughput_speedup']:.4f}",
        occupancy=f"{b['occupancy_mean']:.4f}",
        p50_s=f"{b['latency']['p50']:.4f}",
        p99_s=f"{b['latency']['p99']:.4f}",
        p999_s=f"{b['latency']['p999']:.4f}",
        blocks=blocks, ms_per_block=f"{ms_block:.4f}",
        ms_per_iter=f"{ms_block / B:.4f}",
        sequential_blocks=seq_blocks,
        sequential_ms_per_block=f"{seq_ms_block:.4f}",
        wall_s=f"{b['wall_s']:.3f}", sequential_wall_s=f"{s['wall_s']:.3f}")
    for c in serve["accuracy"]:
        check(c["iters_solo"] == c["iters_batched"] and c["bitwise"],
              f"accuracy rid {c['rid']}: iters {c['iters_solo']} vs "
              f"{c['iters_batched']}, max diff {c['max_abs_diff']}")
    say("solve_serve", stage="accuracy",
        cells=" ".join(f"{c['rid']}:{c['iters_solo']}:{c['max_abs_diff']}"
                       for c in serve["accuracy"]), bitwise=True)
    rel = paced["rel_err"]
    check(rel["p50"] <= SOLVE_SERVE_MODEL_TOL
          and rel["p99"] <= SOLVE_SERVE_MODEL_TOL,
          f"M/G/k quantiles vs replay: {rel}")
    w = paced["wall"]
    say("solve_serve", stage="paced", lam=f"{lam:.4f}",
        t_iter_ms=f"{paced['t_iter_s'] * 1e3:.4f}",
        service_mean_s=f"{paced['service_mean_s']:.4f}",
        wall_p50_s=f"{w['latency']['p50']:.4f}",
        wall_p99_s=f"{w['latency']['p99']:.4f}",
        wall_p999_s=f"{w['latency']['p999']:.4f}",
        wall_occupancy=f"{w['occupancy_mean']:.4f}",
        replay_p50_s=f"{paced['sim']['p50']:.4f}",
        replay_p99_s=f"{paced['sim']['p99']:.4f}",
        model_p50_s=f"{paced['predicted']['p50']:.4f}",
        model_p99_s=f"{paced['predicted']['p99']:.4f}",
        rel_err_p50=f"{rel['p50']:.4f}", rel_err_p99=f"{rel['p99']:.4f}",
        rel_err_p999=f"{rel['p999']:.4f}",
        replay_occupancy=f"{paced['sim_occupancy']:.4f}")

    capped["chaos"] = serve_converged("chaos", csrv.records, reqs)
    check(cstats.drained
          and cstats.n_converged + len(capped["chaos"]) == len(reqs),
          f"chaos: drained {cstats.drained}, converged "
          f"{cstats.n_converged} of {len(reqs)}")
    say("solve_serve", check="converged, or not converged after maxiter "
        "(H14)", **{f"capped_{key.replace(' ', '_')}":
                    ",".join(map(str, v)) or "none"
                    for key, v in capped.items()})
    check(spec.seed == 0 and capped == SOLVE_SERVE_CAPPED,
          f"capped requests {capped}, expected {SOLVE_SERVE_CAPPED} (H14)")
    fired = [e.kind for e in chaos.events]
    n_fatal = sum(kind in ("kill", "corrupt") for kind in fired)
    check(cstats.restarts >= max(2, n_fatal),
          f"chaos: {cstats.restarts} restarts for faults {fired}")
    check("corrupt" in fired and "kill" in fired, f"chaos fired {fired}")
    check(all(d.confirmed for d in csrv.detections),
          "chaos: an unconfirmed detection (a clean column tripped)")
    say("solve_serve", stage="chaos", lane=",".join(SOLVE_SERVE_CHAOS),
        fired=",".join(f"{e.kind}:{e.shard}@{e.at_iter}"
                       for e in chaos.events),
        restarts=cstats.restarts, detections=len(csrv.detections),
        confirmed=sum(bool(d.confirmed) for d in csrv.detections),
        blocks=runs["chaos"]["blocks"], wall_s=f"{cstats.wall_s:.3f}",
        p99_s=f"{cstats.latency.p99:.4f}")

    # each capped request served again through the naive engine (plain
    # torch, no kernel; after the counts were read) at the same maxiter:
    # the fused serve path's true residual is no larger than its
    sources = {"burst": kept["burst_requests"],
               "paced": kept["paced_requests"], "chaos": reqs}
    served = {"burst batched": ("burst", kept["batched"]),
              "burst sequential": ("burst", kept["sequential"]),
              "paced": ("paced", kept["paced"]), "chaos": ("chaos", csrv)}
    distinct = sorted({(served[name][0], rid) for name, rids in
                       capped.items() for rid in rids})
    plain = SolverServer(k_slots=k, step_block=B, engine="naive")
    plain.submit_all([dataclasses.replace(sources[src][rid], rid=i,
                                          arrival_s=0.0)
                      for i, (src, rid) in enumerate(distinct)])
    plain.run()
    plain_res = {distinct[r.rid]: r for r in plain.records}
    versus = []
    for name, rids in capped.items():
        src, srv = served[name]
        recs = {r.rid: r for r in srv.records}
        for rid in rids:
            ref = plain_res[(src, rid)]
            got = recs[rid]
            check(ref.iters == got.iters and got.res_norm <= ref.res_norm,
                  f"{name} request {rid}: fused true residual "
                  f"{got.res_norm:.3e} after {got.iters} iterations, naive "
                  f"{ref.res_norm:.3e} after {ref.iters}")
            versus.append(f"{name.replace(' ', '_')}:{rid}:"
                          f"{got.res_norm:.3e}:{ref.res_norm:.3e}")
    say("solve_serve", check="capped fused true residual <= naive at "
        "maxiter", cases="name:rid:fused:naive " + " ".join(versus))

    # the batch step alone (8 frozen columns, no retire work), timed on
    # the drained batcher after the counts were read
    cur = next(iter(kept["batched"].batchers.values()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SOLVE_SERVE_TIMED_BLOCKS):
        cur.step()
    step_ms = (time.perf_counter() - t0) / SOLVE_SERVE_TIMED_BLOCKS * 1e3
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "solve_serve.json").write_text(json.dumps(jsonable(
        dict(bench_record(serve), detail=serve)), indent=1, sort_keys=True))
    say("solve_serve", step_only_ms_per_block=f"{step_ms:.4f}",
        step_only_ms_per_iter=f"{step_ms / B:.4f}", seconds=f"{seconds:.2f}")


def phase_model():
    import torch
    from repro_torch.core.perfmodel import (SOLVER_SYNC_COUNTS, Exponential,
                                            LogNormal, Uniform,
                                            asymptotic_speedup,
                                            block_expected_max,
                                            crossover_depth,
                                            depth_speedup_ceiling,
                                            depth_speedup_table, harmonic,
                                            modeled_depth_speedup,
                                            s_sync_ceiling, s_sync_speedup,
                                            simulate)
    for P in (2, 4, 64, 8192):
        u = asymptotic_speedup(Uniform(0.0, 1.0), P)
        e = asymptotic_speedup(Exponential(1.0), P)
        ln = asymptotic_speedup(LogNormal(0.0, 1.0), P, method="quad")
        check(all(v == v and v > 0 for v in (u, e, ln)), "speedups")
        say("model", P=P, uniform=f"{u:.4f}", exponential=f"{e:.4f}",
            lognormal=f"{ln:.4f}")
    check(abs(asymptotic_speedup(Exponential(1.0), 4) - 25 / 12) < 1e-14,
          "H_4")
    K, P = 200, 8192
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = simulate(Exponential(1.0), P=P, K=K, trials=256, batch=32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(ms.t_sync.device.type == "cuda", "simulate left the card")
    step = float(ms.t_sync.mean()) / K
    check(abs(step / harmonic(P) - 1.0) < 0.01,
          f"E[max] per step {step} vs H_P {harmonic(P)}")
    sp = ms.speedup_of_means
    check(sp > 2.0, f"speedup_of_means {sp}")
    say("model", simulate=f"Exponential(1) P={P} K={K} trials=256",
        draws=256 * K * P, seconds=f"{dt:.3f}",
        t_sync_per_step=f"{step:.4f}", H_P=f"{harmonic(P):.4f}",
        speedup_of_means=f"{sp:.4f}")
    # the s-sync model: BiCGStab's four synchronizations against one
    check(s_sync_ceiling(2) == 2.0 and s_sync_ceiling(4) == 4.0, "ceilings")
    check(SOLVER_SYNC_COUNTS["bicgstab"] == 4, "BiCGStab sync count")
    lat = (0.0, 0.25, 0.5, 1.0)
    sp4 = [s_sync_speedup(Exponential(1.0), P=4, s=4, red_latency=R)
           for R in lat]
    check(all(a < b for a, b in zip(sp4, sp4[1:])), f"s=4 speedups {sp4}")
    check(sp4[-1] > 2.0, f"s=4 speedup at R=1: {sp4[-1]}")
    far = s_sync_speedup(Exponential(1.0), P=4, s=4, red_latency=1e6)
    check(abs(far - s_sync_ceiling(4)) < 1e-3, f"R -> inf: {far}")
    say("model", s_sync="Exponential(1) P=4 s=4",
        speedup_by_R=" ".join(f"{R}:{v:.4f}" for R, v in zip(lat, sp4)),
        R_1e6=f"{far:.6f}", ceiling=s_sync_ceiling(4))
    # the depth model (tests/test_pipeline_depth.py): monotone in l, under
    # the Eq. 8 ceiling, above 2 at depth
    ceiling = depth_speedup_ceiling(Exponential(1.0), P=4, red_latency=2.0)
    sp = depth_speedup_table(Exponential(1.0), 4, (1, 2, 4, 8),
                             red_latency=2.0, seed=7)
    vals = [sp[l] for l in sorted(sp)]
    check(all(a <= b + 1e-9 for a, b in zip(vals, vals[1:])),
          f"depth speedups not monotone: {sp}")
    check(vals[-1] <= ceiling * 1.02 and vals[-1] > 2.0,
          f"depth speedups {sp} vs ceiling {ceiling}")
    check(sp[4] == modeled_depth_speedup(Exponential(1.0), P=4, l=4,
                                         red_latency=2.0, seed=7),
          "depth table != modeled_depth_speedup")
    say("model", depth="Exponential(1) P=4 R=2",
        speedup_by_l=" ".join(f"{l}:{v:.4f}" for l, v in sp.items()),
        ceiling=f"{ceiling:.4f}",
        crossover_0_9=crossover_depth(sp, ceiling, 0.9),
        block_max_l4=f"{block_expected_max(Exponential(1.0), 4, 4):.4f}")
    model_eq67_and_folk(ms, K, P)
    model_phases()
    model_table1()
    model_trace_large()


def model_eq67_and_folk(ms, K, P):
    """The folk theorem (Section 2) and Eq. 6/7 against the per-step
    means of ``simulate``'s P = 8192 draws above."""
    from repro_torch.core.perfmodel import (Exponential, eq6_iteration_time,
                                            eq7_iteration_time, folk_bound,
                                            overlap_speedup_bound,
                                            staggered_delay_trace,
                                            trace_makespans)
    check(folk_bound(2) == 2.0, "folk bound")
    W, T0, k = 4.0, 1.0, 12
    T, Tp = trace_makespans(staggered_delay_trace(W, T0, k, 2))
    check(abs(T / Tp - overlap_speedup_bound(k * T0 / (W - T0))) < 1e-14
          and T / Tp <= folk_bound(2), f"Eq. 5 on the staggered trace {T/Tp}")
    eq6 = eq6_iteration_time(Exponential(1.0), P, device=DEVICE)
    eq7 = eq7_iteration_time(Exponential(1.0))
    sync_step = float(ms.t_sync.mean()) / K
    async_step = float(ms.t_async.mean()) / K
    check(abs(sync_step / eq6 - 1.0) < 0.01, f"Eq. 6 {eq6} vs {sync_step}")
    # Eq. 7 is the K -> inf mean; at finite K the max over P of the sums
    # sits above it by O(sqrt(log P / K))
    check(eq7 <= async_step <= eq7 * 1.5, f"Eq. 7 {eq7} vs {async_step}")
    say("model", folk_bound=folk_bound(2), eq5_staggered=f"{T / Tp:.6f}",
        eq6_per_step=f"{eq6:.6f}", simulated_sync_per_step=f"{sync_step:.6f}",
        eq7_per_step=f"{eq7:.6f}",
        simulated_async_per_step=f"{async_step:.6f}", P=P, K=K)


def model_phases():
    """``predict_speedup`` on ``ex23_models`` with the port's H100
    ``Hardware()`` (measured hop latency), at depth 1 and 2, P = 4 and
    Piz Daint's 8192, under Exponential waits of NOISE_SCALE seconds."""
    from repro_torch.core.noise import (PIZ_DAINT_P, Hardware, ex23_models,
                                        predict_speedup)
    from repro_torch.core.noise.sampling import scale_distribution
    from repro_torch.core.perfmodel import Exponential
    hw = Hardware()
    noise = scale_distribution(Exponential(1.0), NOISE_SCALE)
    tiny = scale_distribution(Exponential(1.0), 1e-12)
    say("model", hardware=" ".join(f"{k}={v:g}" for k, v in
                                   vars(hw).items()))
    for p in (RANKS, PIZ_DAINT_P):
        m = ex23_models(p, hw)
        for sync, pipe in (("cg", "pipecg"), ("bicgstab", "pipebicgstab")):
            out = {depth: predict_speedup(m[sync], m[pipe], noise, K=5000,
                                          depth=depth, device=DEVICE)
                   for depth in (1, 2)}
            for r in out.values():
                check(r["speedup"] > 1.0 and r["speedup"] == r["speedup"],
                      f"predict_speedup {sync}/{pipe} P={p}: {r}")
            check(out[2]["speedup"] >= out[1]["speedup"],
                  f"depth 2 below depth 1 at P={p}")
            still = predict_speedup(m[sync], m[pipe], tiny, K=100,
                                    device=DEVICE)
            say("model", predict_speedup=f"{sync}/{pipe}", P=p,
                noise=f"Exponential mean {NOISE_SCALE} s",
                speedup_depth1=f"{out[1]['speedup']:.4f}",
                speedup_depth2=f"{out[2]['speedup']:.4f}",
                vanishing_noise=f"{still['speedup']:.4f}",
                t_spmv_s=f"{out[1]['t_spmv']:.3e}",
                t_pipe_compute_s=f"{out[1]['t_pipe_compute']:.3e}",
                t_reduction_s=f"{out[1]['t_reduction']:.3e}",
                latency_bound=out[1]["pipe_latency_bound"])
        if p == PIZ_DAINT_P:
            four = predict_speedup(m["bicgstab"], m["pipebicgstab"], tiny,
                                   K=100, device=DEVICE)["speedup"]
            check(abs(four / 4.0 - 1.0) < 0.01, f"four-sync regime {four}")


def model_table1():
    """The Table-1 fit rows: calibrated runs drawn on the card, the
    Section 4.3 pipeline on each (summary, CvM and Lilliefors verdicts)."""
    import math
    from repro_torch.core.noise import TABLE1, generate_runs
    from repro_torch.core.stats import fit_report
    for alg in TABLE1:
        runs = generate_runs(alg, seed=4, device=DEVICE)
        check(runs.device.type == "cuda", "generate_runs left the card")
        rep = fit_report(runs, name=alg)
        check(all(math.isfinite(v) for v in rep.summary.values())
              and rep.summary["n"] == TABLE1[alg]["n"], f"{alg} summary")
        say("model", table1=rep.table_row(), verdicts=rep.verdict_row(),
            paper_mean=TABLE1[alg]["mean"])


def model_trace_large():
    """``makespan_trace_large`` at Piz Daint scale (P = 8192, K = 5000),
    both makespans from the same draws, timed on the card."""
    import torch
    from repro_torch.core.noise import (EX23_ITERS, PIZ_DAINT_P,
                                        makespan_trace_large)
    from repro_torch.core.perfmodel import harmonic
    P, K, t0, scale = PIZ_DAINT_P, EX23_ITERS, 1.0, 1.0
    kw = dict(t0=t0, noise_scale=scale, trials=TRACE_TRIALS, seed=0,
              device=DEVICE)
    torch.cuda.synchronize()
    start = time.perf_counter()
    T = makespan_trace_large(P, K, sync=True, **kw)
    Tp = makespan_trace_large(P, K, sync=False, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - start
    check(T.device.type == "cuda" and tuple(T.shape) == (TRACE_TRIALS,),
          "makespan_trace_large left the card")
    step = float(T.mean()) / K
    check(abs(step / (t0 + scale * harmonic(P)) - 1.0) < 0.01,
          f"T per step {step} vs t0 + H_P")
    check(bool((Tp <= T).all()), "T' above T on the same draws")
    sp = float(T.mean()) / float(Tp.mean())
    say("model", makespan_trace_large=f"P={P} K={K} trials={TRACE_TRIALS}",
        draws=2 * TRACE_TRIALS * K * P, seconds=f"{dt:.3f}",
        t_sync_per_step=f"{step:.4f}", speedup_of_means=f"{sp:.4f}",
        H_P_plus_1=f"{harmonic(P) + 1:.4f}")


def main() -> int:
    why = prepare()
    if why:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    import torch

    name, _ = phase_device()
    phase_build()
    records = phase_kernels()
    phase_main_path(records)
    phase_bicgstab(records)
    phase_depth(records)
    phase_gmres(records)
    phase_bsr(records)
    phase_ranks(records)
    phase_wire(records)
    phase_resilient(records)
    phase_wkv_entry(records)
    phase_serve(records)
    phase_solve_serve(records)
    phase_model()
    order = ("spmv_dia", "spmv_dia_ext", "pipecg_spmv_fused",
             "pipecg_spmv_halo",
             "ghost_chain_fused", "ghost_chain_halo", "pipecg_fused",
             "fused_dots", "pipebicgstab_fused", "pipebicgstab_halo",
             "spmv_bsr", "pipecg_bsr_fused", "flash_attention",
             "wkv_recurrent")
    print(json.dumps({"kernels": [records[k] for k in order]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
