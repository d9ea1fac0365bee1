#!/usr/bin/env python3
"""Where one fused PIPECG, p-BiCGStab, depth-l iteration, (P)GMRES
Arnoldi step or serve-batcher iteration spends its time.

    python3 torch_pipecg_breakdown.py [pipecg | pipecg_bsr | pipebicgstab |
                                       pipecg_l [L] | gmres | pgmres |
                                       serve_block]

Run from the root of a checkout on one NVIDIA GPU (exits with 2 without
one).  Solves ex23 (chip_smoke.py's problem: the tridiagonal Laplacian at
n = 2,097,152, float64) for 200 iterations with ``pipecg(engine="fused")``
or, given ``pipebicgstab``, the convection-diffusion problem of
chip_smoke.py's ``[bicgstab]`` phase with ``pipebicgstab(M="jacobi",
engine="fused")``, or, given ``pipecg_l``, ex23 with
``pipecg_l(engine="fused", depth=L)`` (L = 2 unless given: one ghost-chain
sweep per block of L iterations), or, given ``pipecg_bsr``, ex23 as a
``BsrMatrix`` at bs 4 (chip_smoke.py's ``[bsr]`` phase: one BSR sweep per
iteration), or, given ``gmres`` / ``pgmres``, one restart-40 cycle of it on
ex23 through the fused engine (chip_smoke.py's ``[gmres]``; per Arnoldi
step: 40 steps, PGMRES's 42), or, given ``serve_block``, 25 blocks of 8
iterations of the serve batcher (``serve.ContinuousBatcher`` on ex23, k =
8, fused engine, 8 columns admitted from chip_smoke.py's
``[solve_serve]`` workload; per iteration: 200), and reports

* the host-clock time per iteration of a synchronised solve (best of 3),
  and of one solve with ``torch.profiler`` attached;
* from the profiler's device events, the device time per iteration by
  group: the sweep kernel and its fixed-order reduce, the SpMV and
  multi-dot kernels, ``torch.where`` (the masked freeze), cuBLAS (the
  depth path's block-end reconstruction and coefficient-space products,
  GMRES's basis products), the scalar recurrence and bookkeeping ops; and
  the device's idle share of the profiled wall time.

Prints one JSON object as its last line.  Where the profiler's averages
show no device time, the groups read "not measured".
"""
from __future__ import annotations

import json
import sys
import time

import chip_smoke as smoke

ITERS = 200
# the row-window sweeps (pipecg_sweep_kernel, pipebicgstab_sweep_kernel)
# and the ghost-chain sweep (ghost_chain_kernel) finish their sums inside
# the launch (ticketed CTAs), so "sweep kernel" holds their finish; older
# checkouts' sweeps (finish_chain_gram_kernel for the chain) and the other
# kernels finish in "sweep reduce"
GROUPS = (
    ("sweep kernel", ("pipecg_sweep_kernel", "pipebicgstab_sweep_kernel",
                      "pipecg_spmv_fused_kernel",
                      "pipebicgstab_fused_kernel", "ghost_chain_kernel",
                      "pipecg_bsr_fused_kernel")),
    ("sweep reduce", ("reduce_rows_kernel", "finish_gram_kernel",
                      "finish_chain_gram_kernel")),
    ("spmv kernel", ("spmv_dia_kernel", "spmv_bsr_kernel")),
    ("multi-dot kernel", ("fused_dots_kernel",)),
    ("torch.where (freeze)", ("where",)),
    ("cuBLAS (reconstruction, small products)", ("gemv", "gemm", "dot_kernel",
                                                 "cublas", "cutlass", "xmma")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return label
    return "other elementwise/scalar ops"


def main() -> int:
    why = smoke.prepare()
    if why:
        print(f"torch_pipecg_breakdown: {why}", file=sys.stderr)
        return 2
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.krylov import (SolverOptions, dia_to_bsr, gmres,
                                         pgmres, pipebicgstab, pipecg,
                                         pipecg_l)

    solver = sys.argv[1] if len(sys.argv) > 1 else "pipecg"
    if solver not in ("pipecg", "pipecg_bsr", "pipebicgstab", "pipecg_l",
                      "gmres", "pgmres", "serve_block"):
        print(f"torch_pipecg_breakdown: unknown solver {solver!r}",
              file=sys.stderr)
        return 2
    _, card = smoke.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    depth = int(sys.argv[2]) if solver == "pipecg_l" and len(sys.argv) > 2 \
        else 2
    iters, kw = ITERS, {}
    if solver in ("gmres", "pgmres"):
        A, b = smoke.ex23(gen)
        run = gmres if solver == "gmres" else pgmres
        opts = SolverOptions(engine="fused")
        kw = dict(restart=smoke.GMRES_RESTART)
        iters = smoke.GMRES_RESTART + (2 if solver == "pgmres" else 0)
    elif solver in ("pipecg", "pipecg_bsr"):
        A, b = smoke.ex23(gen)
        if solver == "pipecg_bsr":
            A = dia_to_bsr(A, bs=smoke.BSR_BS)
        run, opts = pipecg, SolverOptions(engine="fused", maxiter=ITERS)
    elif solver == "serve_block":
        from repro_torch.serve import ContinuousBatcher, synthetic_requests
        A, b = smoke.ex23(gen)
        batcher = ContinuousBatcher(A, 8, step_block=8)
        for slot, req in enumerate(synthetic_requests(
                A, 8, tol=1e-8, maxiter=600, modes=(32, 256), seed=0)):
            batcher.admit(slot, req)
        opts = None

        def run(*_args, **_kw):
            for _ in range(ITERS // batcher.step_block):
                batcher.step()
    elif solver == "pipecg_l":
        A, b = smoke.ex23(gen)
        run, opts = pipecg_l, SolverOptions(engine="fused", maxiter=ITERS,
                                            depth=depth)
    else:
        A, b = smoke.convdiff(gen)
        run, opts = pipebicgstab, SolverOptions(engine="fused", M="jacobi",
                                                maxiter=ITERS)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(A, b, options=opts, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    solve()  # build + warm up
    wall = min(solve() for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = solve()
    groups, kernels = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            g = _group(ev.key)
            groups[g] = groups.get(g, 0.0) + us
            kernels[ev.key[:100]] = (us / iters, ev.count / iters)
    busy_us = sum(groups.values())
    per_iter = {g: us / iters for g, us in sorted(groups.items())}
    result = {
        "card": card, "solver": solver, "n": smoke.N_EX23, "iters": iters,
        "depth": depth if solver == "pipecg_l" else 1,
        "wall_ms_per_iter": wall / iters * 1e3,
        "wall_ms_per_iter_profiled": wall_prof / iters * 1e3,
        "device_us_per_iter": per_iter if busy_us else "not measured",
        "device_busy_us_per_iter": busy_us / iters if busy_us
        else "not measured",
        "device_idle_share": 1.0 - busy_us * 1e-6 / wall_prof if busy_us
        else "not measured",
        "top_kernels_us_and_launches_per_iter": sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:10],
    }
    for g, us in per_iter.items():
        print(f"{g:32s} {us:10.3f} us/iter")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
