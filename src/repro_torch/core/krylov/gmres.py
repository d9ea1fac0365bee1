"""GMRES(m) with modified Gram-Schmidt (the paper's Algorithm 1).

Classical GMRES synchronizes once per *orthogonalization coefficient*: in
MGS every h_{j,i} gates the update of z before the next dot, so the inline
path (``engine=None``, the one ``distributed_solve`` runs with an
all-reduce dot) issues i + 1 dots at Arnoldi step i, then the norm.  An
engine (``"naive"`` / ``"fused"``) takes all h_{j,i} from the SAME z in
one multi-dot over the whole (m + 1, n) basis (classical Gram-Schmidt;
kernels/fused_dots.py on the card), the inactive rows masked to 0.

Fixed trip, as the reference's ``fori_loop``: one cycle runs ``restart``
Arnoldi steps, ``res_history`` has length ``restart`` and holds the
progressive-Givens residual estimate, and ``iters`` is ``restart``.  No
value comes back to the host inside the Arnoldi loop.  The Givens
recurrence feeds only ``res_history`` (the minimizer comes from a least
squares on H), so it runs once after the loop, on the host, in the
reference's order (:func:`givens_history`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.krylov.base import SolveResult, as_matvec, local_dot
from repro_torch.core.krylov.engine import _resolve_M, get_engine
from repro_torch.core.krylov.options import (UNSET, SolverOptions,
                                             check_supported,
                                             resolve_options)
from repro_torch.core.krylov.pipeline import _lstsq


def _lstsq_hessenberg(H, beta, m):
    """argmin || beta e1 - H y ||, H (m+1, m), by the SVD least squares
    (``torch.linalg.lstsq`` on CUDA has only the full-rank ``gels``, and a
    breakdown leaves H rank-deficient)."""
    rhs = torch.zeros((H.shape[0],), dtype=H.dtype, device=H.device)
    rhs[0] = beta
    return _lstsq(H, rhs)


def givens_history(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The progressive-Givens residual estimates of one GMRES cycle.

    ``res_history[i]`` = |g_{i+1}| after rotating Hessenberg column i
    (of ``H``, (m+1, m)) by rotations 0..i-1 and forming rotation i from
    the result (c = 1, s = 0 where both entries are 0), with g = beta e1:
    the reference's recurrence, rotation by rotation in its order, on the
    host, each operation rounded to H's dtype (float32 for a narrower
    one).  Nothing in the Arnoldi loop reads it, so it runs once after
    the loop: one copy of H off the device instead of m dependent rounds
    of 2 x 2 ops a step.  Returns (m,) on H's device.
    """
    m = H.shape[1]
    flat = torch.cat([H.reshape(-1), beta.reshape(1)]).cpu()
    if flat.dtype == torch.float64:
        flat, sqrt = flat.tolist(), math.sqrt      # Python floats: f64
    else:
        flat, sqrt = list(flat.float().numpy()), np.sqrt   # f32 scalars
    one, zero = type(flat[0])(1.0), type(flat[0])(0.0)
    cs, sn = [zero] * m, [zero] * m
    g = [zero] * (m + 1)
    g[0] = flat[-1]
    hist = [zero] * m
    for i in range(m):
        col = [flat[j * m + i] for j in range(m + 1)]
        for j in range(i):
            t = cs[j] * col[j] + sn[j] * col[j + 1]
            col[j + 1] = -sn[j] * col[j] + cs[j] * col[j + 1]
            col[j] = t
        denom = sqrt(col[i] * col[i] + col[i + 1] * col[i + 1])
        cs[i] = col[i] / denom if denom > 0 else one
        sn[i] = col[i + 1] / denom if denom > 0 else zero
        hist[i] = abs(-sn[i] * g[i])
        g[i + 1] = -sn[i] * g[i]
        g[i] = cs[i] * g[i]
    return torch.tensor(np.array(hist, dtype=type(one)), dtype=H.dtype,
                        device=H.device)


def _cycle_operators(A, M, dot, engine):
    """(mv, M, eng) of one cycle; an engine refuses a custom dot."""
    eng = get_engine(engine)
    if eng is not None:
        if dot is not local_dot:
            raise ValueError(
                "engine= computes local reductions and cannot honor a custom "
                "dot (e.g. a distributed dot); use engine=None there")
        return (lambda v: eng.spmv(A, v)), _resolve_M(A, M), eng  # noqa: E731
    return as_matvec(A), _resolve_M(A, M), None


def _one_cycle_options(options, solver, supported, **legacy):
    """Resolved options of one restart cycle (no ``maxiter`` of its own)."""
    opts = resolve_options(options, **legacy)
    check_supported(opts, solver, supported=supported)
    if opts.maxiter != SolverOptions().maxiter:
        raise ValueError(
            f"{solver}() runs one restart cycle: its iteration count is "
            "restart=, and outer cycles belong to gmres_restarted "
            "(cycles=, inner=); options.maxiter is not honored")
    return opts


def _residual(b, mv, x, dot):
    r = b - mv(x)
    return torch.sqrt(torch.clamp(dot(r, r), min=0.0))


def gmres(A, b, x0=None, *, restart: int = 30, tol=UNSET, M=UNSET,
          dot=local_dot, engine=UNSET, options=None) -> SolveResult:
    """Single-cycle GMRES(restart), Algorithm 1 of the paper.

    Returns the minimizer over the Krylov space of dimension ``restart``.
    ``res_history[i]`` is the residual estimate after i+1 Arnoldi steps
    (progressive Givens).  ``engine`` switches the orthogonalization from
    per-coefficient MGS dots to the engine's one-pass multi-dot (CGS
    order); the minimizer is the same, per-step coefficients differ at
    roundoff.  ``options=SolverOptions(...)`` spells ``tol`` / ``M`` /
    ``engine``; GMRES has no ``maxiter`` (the cycle length is
    ``restart``), so a non-default ``options.maxiter`` raises.
    """
    opts = _one_cycle_options(options, "gmres", ("engine",), tol=tol, M=M,
                              engine=engine)
    mv, Mf, eng = _cycle_operators(A, opts.M, dot, opts.engine)
    x = torch.zeros_like(b) if x0 is None else x0
    m = restart
    n = b.shape[0]
    dt, dev = b.dtype, b.device

    r0 = Mf(b - mv(x))
    beta = torch.sqrt(dot(r0, r0))
    V = torch.zeros((m + 1, n), dtype=dt, device=dev)
    V[0] = r0 / beta
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    active = (torch.arange(m + 1, device=dev)[None, :]
              <= torch.arange(m, device=dev)[:, None]).to(dt)

    for i in range(m):
        z = Mf(mv(V[i]))
        if eng is not None:
            # classical GS: every h_{j,i} from the same z, ONE memory pass
            # (rows past i are 0: the product skips them)
            hcol = eng.dots(V, z) * active[i]
            z = z - hcol[:i + 1] @ V[:i + 1]
        else:
            # MGS: coefficient j > i is exactly 0 in the reference's masked
            # loop, so stopping at j = i leaves the same bits
            hcol = torch.zeros((m + 1,), dtype=dt, device=dev)
            for j in range(i + 1):
                hji = dot(z, V[j])
                z = z - hji * V[j]
                hcol[j] = hji
        hnorm = torch.sqrt(dot(z, z))
        hcol[i + 1] = hnorm
        V[i + 1] = z / torch.where(hnorm > 0, hnorm, 1.0)
        H[:, i] = hcol

    hist = givens_history(H, beta)
    y = _lstsq_hessenberg(H, beta, m)
    x_final = x + V[:m].T @ y
    return SolveResult(x=x_final,
                       iters=torch.tensor(m, dtype=torch.int32, device=dev),
                       res_norm=_residual(b, mv, x_final, dot),
                       res_history=hist)


def gmres_restarted(A, b, x0=None, *, restart: int = 30, cycles: int = 5,
                    tol: float = 0.0, M=None, dot=local_dot, inner=None,
                    engine=None) -> SolveResult:
    """GMRES(m) with restarts: ``cycles`` outer cycles of ``restart`` inner
    Arnoldi steps (``inner=pgmres`` gives restarted PGMRES).

    The inner solver is called with ``options=SolverOptions(...)``; a
    custom ``inner=`` must accept that kwarg.  Each cycle ends with one
    host read of the residual for the ``tol`` test, as the reference's.
    """
    solver = inner if inner is not None else gmres
    x = torch.zeros_like(b) if x0 is None else x0
    hists = []
    iters = 0
    res = None
    opts = SolverOptions(tol=tol, M=M, engine=engine)
    for _ in range(cycles):
        out = solver(A, b, x, restart=restart, dot=dot, options=opts)
        x = out.x
        hists.append(out.res_history)
        iters += int(out.iters)
        res = out.res_norm
        if tol > 0 and float(res) <= tol * float(torch.sqrt(dot(b, b))):
            break
    return SolveResult(x=x, iters=torch.tensor(iters, dtype=torch.int32,
                                               device=b.device),
                       res_norm=res, res_history=torch.cat(hists))
