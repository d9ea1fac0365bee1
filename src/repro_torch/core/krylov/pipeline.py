"""Depth-l pipelined Krylov solvers: ``pipecg_l`` and ``pgmres_l``.

Depth-1 pipelining (PIPECG / p(1)-GMRES) overlaps ONE global reduction
with one SpMV of work.  The stochastic model (PAPER.md Eqs. 6/7) predicts
the attainable speedup grows when the reduction is given more than one
SpMV to hide behind, which is what depth-l pipelining provides (Sanan et
al., "Pipelined, Flexible Krylov Subspace Methods"; Cornelis, Cools &
Vanroose's deep pipelines; Cools' accuracy analysis bounds how far l can
be pushed).

Depth l >= 2 runs in the ghost-basis (communication-avoiding)
formulation: each block builds the theta-scaled ghost basis

    C = [p, A~p, ..., A~^l p, r, A~r, ..., A~^(l-1) r],    A~ = A / theta,

takes ONE Gram reduction G = C C^T (the (2l+1)^2 payload that replaces l
per-iteration (gamma, delta, ||r||^2) rows), and runs l exact CG steps in
(2l+1)-dimensional coefficient space, with no further reduction until the
next block.  In exact arithmetic the iterates equal CG's; in floating
point the monomial basis conditions like kappa(A)^l, the Cools-style
accuracy bound on the depth: l in {2, 4} tracks the depth-1 history to
~1e-10 on the paper's Table-1 operators, l = 8 stagnates visibly
(tests/test_torch_depth.py).  ``rr`` (a block period) recomputes
r = b - A x to bound the true-residual drift at large l.

At l = 1 ``pipecg_l`` IS :func:`repro_torch.core.krylov.cg.pipecg`.

Semantics follow the JAX package's ``lax.scan`` (fixed trip count): the
loop runs ``ceil(maxiter / l)`` blocks, a converged solve is frozen by a
masked update, ``res_history`` keeps ``maxiter`` entries and ``iters``
grows by l per live block.  The block loop runs in Python with theta and
every recurrence scalar on the device: no block waits for the host,
except the adaptive ``rr_tau > 0`` replacement, whose trigger depends on
the data and costs one host read per block.

Under ``engine="fused"`` a DIA operator's chain and Gram are one kernel
sweep per block (kernels/pipecg_spmv_fused.py::ghost_chain_fused); the
per-rank form, with one l*h strip exchange and one all-reduce per block,
is ``core/krylov/distributed.py::sharded_pipecg_depth_solve``.  The
block-end reconstruction ``x + C^T xc`` is a plain matrix product, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.krylov import abft
from repro_torch.core.krylov.base import SolveResult, as_matvec
from repro_torch.core.krylov.engine import (FusedEngine, ShardedFusedEngine,
                                            get_engine)
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import (UNSET, SolverOptions,
                                             check_supported, resolve_options)


def dia_inf_norm(A: DiaMatrix) -> torch.Tensor:
    """||A||_inf of a DIA operator: max row sum of absolute band values.

    A 0-d tensor on A's device.  Used as the ghost-basis scale theta so
    the chain A~^j v = (A/theta)^j v stays O(||v||).
    """
    return torch.max(torch.sum(torch.abs(A.bands), dim=0))


def symmetrized_jacobi(A: DiaMatrix, b: torch.Tensor
                       ) -> Tuple[DiaMatrix, torch.Tensor, torch.Tensor]:
    """Split-preconditioned (symmetrized) Jacobi system.

    Returns ``(A_hat, b_hat, ds)`` with ``A_hat = D^-1/2 A D^-1/2``,
    ``b_hat = D^-1/2 b`` and ``ds = diag(A)^-1/2``; the solution maps
    back as ``x = ds * x_hat``.  Exact for SPD A, and keeps the operator
    in DIA form so the ghost-chain kernel applies unchanged.  The solver
    then reports preconditioned residual norms.
    """
    ds = 1.0 / torch.sqrt(A.diagonal())
    n, h = A.n, A.halo
    ds_ext = F.pad(ds, (h, h))
    # A_hat[i, i+off] = ds[i] * A[i, i+off] * ds[i+off]
    bands = [A.bands[k] * ds * ds_ext[h + off:h + off + n]
             for k, off in enumerate(A.offsets)]
    return DiaMatrix(offsets=A.offsets, bands=torch.stack(bands)), b * ds, ds


def _resolve_depth_system(A, b, M, theta):
    """(A, b, unscale, theta) for the depth-l solvers.

    ``M`` may be None or ``"jacobi"`` (symmetrized in); opaque callables
    cannot ride the ghost chain and are rejected with a pointer to the
    depth-1 solvers.
    """
    if M is None:
        unscale = None
    elif isinstance(M, str) and M == "jacobi":
        if not isinstance(A, DiaMatrix):
            raise ValueError("depth-l M='jacobi' needs a DiaMatrix operator")
        A, b, unscale = symmetrized_jacobi(A, b)
    else:
        raise ValueError(
            "depth-l solvers precondition via the symmetrized operator: M "
            f"must be None or 'jacobi', got {M!r}; use the depth-1 solvers "
            "(pipecg / pgmres) for an opaque callable M")
    if theta is None:
        if not isinstance(A, DiaMatrix):
            raise ValueError(
                "depth-l solvers need theta= (a ||A||_inf-scale estimate) "
                "for non-DIA operators; DIA operators derive it locally")
        theta = dia_inf_norm(A)
    return A, b, unscale, torch.as_tensor(theta, dtype=b.dtype,
                                          device=b.device)


def _shift_matrix(l: int, dtype, device=None) -> torch.Tensor:
    """Coefficient-space rendering of theta * A~ on the ghost basis.

    Basis columns 0..l are A~^j p, columns l+1..2l are A~^j r;
    multiplying by A shifts each chain one slot deeper (the top-degree
    columns are never multiplied again within a block, which bounds the
    block at l steps).
    """
    m = 2 * l + 1
    T = torch.zeros((m, m), dtype=dtype, device=device)
    for j in range(l):
        T[j + 1, j] = 1.0
    for j in range(l - 1):
        T[l + 2 + j, l + 1 + j] = 1.0
    return T


def _unit(m: int, i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros((m,), dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


def _block_cg_steps(G, Tm, l: int, theta, done):
    """l exact CG steps in ghost-basis coefficient space.

    ``G`` is the block's Gram matrix (its one reduction), ``Tm`` the shift
    matrix of :func:`_shift_matrix` (times theta it represents A).
    Returns (xc, rc, pc, hist) where hist (l,) holds the post-step
    residual norms sqrt(rc G rc); ``done`` (0-d bool) freezes the
    recurrence, the masked update of the other solvers.
    """
    m = G.shape[0]
    pc = _unit(m, 0, G)
    rc = _unit(m, (m + 1) // 2, G)
    xc = torch.zeros_like(pc)
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    one = torch.ones_like(zero)
    hist = []
    for _ in range(l):
        w = theta * (Tm @ pc)             # coords of A p
        rho = torch.clamp(rc @ G @ rc, min=0.0)
        den = pc @ G @ w
        alpha = torch.where((rho > 0) & (den != 0),
                            rho / torch.where(den != 0, den, one), zero)
        alpha = torch.where(done, zero, alpha)
        xc = xc + alpha * pc
        rc_new = rc - alpha * w
        rho_new = torch.clamp(rc_new @ G @ rc_new, min=0.0)
        beta = torch.where(rho > 0, rho_new / torch.where(rho > 0, rho, one),
                           zero)
        rc = torch.where(done, rc, rc_new)
        pc = torch.where(done, pc, rc_new + beta * pc)
        hist.append(torch.sqrt(torch.clamp(rc @ G @ rc, min=0.0)))
    return xc, rc, pc, torch.stack(hist)


def _ghost_chain(A, p, r, theta, l: int, eng) -> Tuple:
    """(chain (2l+1, n), gram (2l+1, 2l+1)) for one depth-l block.

    The FusedEngine runs the single-sweep chain kernel on a DIA operator;
    other engines build the chain with plain matvecs divided by theta and
    one matrix product for the Gram.
    """
    if isinstance(eng, FusedEngine) and isinstance(A, DiaMatrix):
        from repro_torch.kernels import ops as kops
        return kops.ghost_chain_step(A.offsets, A.bands, p, r, theta, l)
    mv = as_matvec(A)
    rows = [p]
    for _ in range(l):
        rows.append(mv(rows[-1]) / theta)
    rrows = [r]
    for _ in range(l - 1):
        rrows.append(mv(rrows[-1]) / theta)
    C = torch.stack(rows + rrows)
    return C, C @ C.T


def pipecg_l(A, b, x0=None, *, l=UNSET, maxiter=UNSET, tol=UNSET, M=UNSET,
             engine=UNSET, rr=UNSET, rr_tau=UNSET,
             theta: Optional[float] = None, options=None) -> SolveResult:
    """Depth-l pipelined CG.

    ``l = 1`` delegates to the Ghysels-Vanroose PIPECG recurrence; ``l >=
    2`` runs the ghost-basis blocks of the module docstring: one Gram
    reduction per l iterations, 2l - 1 SpMVs per block.

    l:
        Pipeline depth (reduction-to-consumption distance, iterations).
    rr:
        Residual-replacement period in blocks (0 = off): every ``rr``
        blocks r is recomputed as ``b - A x`` (one extra SpMV, paid only
        on those blocks: the period is known on the host).
    rr_tau:
        Adaptive residual replacement (0 = off): the block-aggregated
        deviation recursion of core/krylov/abft.py fires the same
        replacement when its estimate crosses ``rr_tau`` times the
        residual.  Its trigger is data: one host read per block.
    theta:
        Ghost-basis scale (a ||A||_inf estimate); derived on the device
        for DIA operators, required for matrix-free ones.

    ``M`` may be None or ``"jacobi"`` (symmetrized split preconditioning;
    residual norms are then the preconditioned ones).  ``engine``:
    ``"fused"`` runs the ghost-chain kernel, None / ``"naive"`` plain
    matvecs.  ``options=SolverOptions(...)`` is the typed spelling;
    ``options.depth`` is ``l``.
    """
    opts = resolve_options(options, l=l, maxiter=maxiter, tol=tol, M=M,
                           engine=engine, rr=rr, rr_tau=rr_tau)
    check_supported(opts, "pipecg_l",
                    supported=("engine", "depth", "rr", "rr_tau"))
    l, maxiter, tol, M = opts.depth, opts.maxiter, opts.tol, opts.M
    engine, rr, rr_tau = opts.engine, opts.rr, opts.rr_tau
    if l < 1:
        raise ValueError(f"pipeline depth l must be >= 1, got {l}")
    if l == 1:
        from repro_torch.core.krylov.cg import pipecg
        # rr has no depth-1 analogue (its periods count blocks): dropped
        return pipecg(A, b, x0, options=dataclasses.replace(
            opts, depth=1, rr=0,
            engine=engine if (engine is not None or not rr_tau)
            else "naive"))
    eng = get_engine(engine)
    if isinstance(eng, ShardedFusedEngine):
        raise ValueError(
            "engine='sharded_fused' must run on a process group: use "
            "distributed_solve(pipecg_l, A, b, group, "
            "engine='sharded_fused', l=...) instead of the local entry")
    A_h, b_h, unscale, theta = _resolve_depth_system(A, b, M, theta)
    if x0 is None:
        x = torch.zeros_like(b_h)
    else:
        x = x0 if unscale is None else x0 / unscale
    mv = as_matvec(A_h)
    r = b_h - mv(x)
    p = r
    dt, dev_ = b_h.dtype, b_h.device
    Tm = _shift_matrix(l, dt, dev_)
    nblocks = -(-maxiter // l)
    tol2 = torch.as_tensor(tol, dtype=dt, device=dev_) ** 2 \
        * torch.sum(b_h * b_h)
    rr_period = int(rr)
    adaptive = float(rr_tau) > 0.0
    eps_u = abft.machine_eps(dt)
    zero = torch.zeros((), dtype=dt, device=dev_)
    dev = zero
    done = torch.zeros((), dtype=torch.bool, device=dev_)
    iters = torch.zeros((), dtype=torch.int32, device=dev_)
    step = torch.tensor(l, dtype=torch.int32, device=dev_)
    hists = []
    for bi in range(nblocks):
        C, G = _ghost_chain(A_h, p, r, theta, l, eng)
        xc, rc, pc, hist = _block_cg_steps(G, Tm, l, theta, done)
        x_new = x + xc @ C
        p_new = torch.where(done, p, pc @ C)
        r_new = rc @ C
        dev_new = dev
        if rr_period or adaptive:
            fire = bool(rr_period) and (bi + 1) % rr_period == 0
            do_rr = torch.tensor(fire, device=dev_)
            if adaptive:
                rr2_c = torch.clamp(rc @ G @ rc, min=0.0)
                dev_new = abft.deviation_update_block(dev, l, theta, rr2_c,
                                                      eps=eps_u)
                do_rr = do_rr | abft.deviation_trip(dev_new, rr2_c, rr_tau)
            do_rr = do_rr & ~done
            # the replacement SpMV runs only on replacement blocks; the
            # adaptive trigger is read on the host (one sync per block)
            if fire or (adaptive and bool(do_rr)):
                r_new = torch.where(do_rr, b_h - mv(x_new), r_new)
                dev_new = torch.where(do_rr, zero, dev_new)
        x_new = torch.where(done, x, x_new)
        r_new = torch.where(done, r, r_new)
        dev = torch.where(done, dev, dev_new)
        rr2 = torch.sum(r_new * r_new)
        hists.append(torch.where(done, torch.sqrt(torch.clamp(rr2, min=0.0)),
                                 hist))
        iters = iters + torch.where(done, torch.zeros_like(step), step)
        done = done | (rr2 <= tol2)
        x, r, p = x_new, r_new, p_new
    hist = (torch.cat(hists) if hists
            else torch.zeros((0,), dtype=dt, device=dev_))[:maxiter]
    res = torch.sqrt(torch.clamp(torch.sum(r * r), min=0.0))
    x_out = x if unscale is None else x * unscale
    return SolveResult(x=x_out, iters=torch.clamp(iters, max=maxiter),
                       res_norm=res, res_history=hist)


# ---------------------------------------------------------------------------
# Depth-l pipelined GMRES
# ---------------------------------------------------------------------------

def _lstsq(A, b):
    """min ||A t - b|| by SVD with the JAX package's cut-off.

    Singular values below ``eps * max(A.shape) * s_max`` are dropped, as
    ``jnp.linalg.lstsq(rcond=None)`` does; ``torch.linalg.lstsq`` on CUDA
    has only the full-rank ``gels`` routine, and the clipped Gram factors
    here are rank-deficient by construction.
    """
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return Vh.T @ (s_inv * (U.T @ b))


def _clipped_eigh(G, eps: float):
    evals, evecs = torch.linalg.eigh(G)
    emax = torch.clamp(evals[-1], min=0.0)
    good = evals > eps * torch.where(emax > 0, emax, torch.ones_like(emax))
    return evals, evecs, good


def _gram_solve(G, B, rhs, eps: float = 1e-12):
    """min_t || rhs - B t ||_G via an eigenvalue-clipped Gram factor.

    ``G`` is a (possibly numerically singular) Gram matrix; eigenvalues
    below ``eps * max`` are clipped, which handles happy breakdown and
    degenerate Krylov spaces the way a rank-revealing LS would.
    Returns ``(t, res_norm)``.
    """
    evals, evecs, good = _clipped_eigh(G, eps)
    root = torch.where(good, torch.sqrt(torch.clamp(evals, min=0.0)),
                       torch.zeros_like(evals))
    L = evecs * root                    # G ~= L L^T on the kept spectrum
    t = _lstsq(L.T @ B, L.T @ rhs)
    resid = rhs - B @ t
    return t, torch.sqrt(torch.clamp(resid @ G @ resid, min=0.0))


def _clipped_solve(G, rhs, eps: float = 1e-12):
    """Solve ``G t = rhs`` with eigenvalue clipping (pseudo-inverse).

    The coefficient-space CGS projection: clipped directions contribute
    nothing (they belong to numerically dependent basis columns).
    """
    evals, evecs, good = _clipped_eigh(G, eps)
    inv = torch.where(good, 1.0 / torch.where(good, evals,
                                              torch.ones_like(evals)),
                      torch.zeros_like(evals))
    return evecs @ (inv * (evecs.T @ rhs))


def pgmres_l(A, b, x0=None, *, restart: int = 30, l=UNSET, tol=UNSET,
             M=UNSET, theta: Optional[float] = None, engine=UNSET,
             options=None) -> SolveResult:
    """Depth-l pipelined GMRES (ghost-basis blocks, Gram-space LS).

    Per block of l iterations: orthogonalize the newest basis vector in
    coefficient space (with the incrementally built Gram matrix, no
    reduction), extend the basis with l theta-scaled operator powers (l
    SpMVs), and take ONE reduction for the new Gram rows.  The minimal
    residual solution comes at the end from the generator relation
    ``A (Z Y) = theta * Z E`` by a Gram-metric least squares.

    ``M`` may be None or ``"jacobi"`` (row scaling D^-1 A; residual norms
    are then preconditioned norms).  ``restart`` rounds up to a multiple
    of ``l``.  ``engine`` routes the chain SpMVs (``"fused"``: the DIA
    SpMV kernel).  ``tol`` is accepted for interface parity: one restart
    cycle runs to completion.  With neither ``l=`` nor ``options=`` the
    historical default depth 2 applies.
    """
    opts = resolve_options(options, l=l, tol=tol, M=M, engine=engine)
    check_supported(opts, "pgmres_l", supported=("engine", "depth"))
    if opts.maxiter != SolverOptions().maxiter:
        raise ValueError(
            "pgmres_l() runs one restart cycle: its iteration count is "
            "restart= (rounded up to a multiple of l); options.maxiter "
            "is not honored")
    M, engine = opts.M, opts.engine
    l = 2 if (options is None and l is UNSET) else opts.depth
    if l < 1:
        raise ValueError(f"pipeline depth l must be >= 1, got {l}")
    if isinstance(M, str) and M == "jacobi":
        if not isinstance(A, DiaMatrix):
            raise ValueError("depth-l M='jacobi' needs a DiaMatrix operator")
        invd = 1.0 / A.diagonal()
        A = DiaMatrix(offsets=A.offsets, bands=torch.stack(
            [A.bands[k] * invd for k in range(len(A.offsets))]))
        b = b * invd
    elif M is not None:
        raise ValueError(
            "depth-l pgmres preconditions by operator scaling: M must be "
            f"None or 'jacobi', got {M!r}; use pgmres (depth 1) for an "
            "opaque callable M")
    if theta is None:
        if not isinstance(A, DiaMatrix):
            raise ValueError(
                "depth-l solvers need theta= for non-DIA operators")
        theta = dia_inf_norm(A)
    eng = get_engine(engine)
    if eng is not None and isinstance(A, DiaMatrix):
        mv = lambda v: eng.spmv(A, v)  # noqa: E731
    else:
        mv = as_matvec(A)
    dt, dev = b.dtype, b.device
    theta = torch.as_tensor(theta, dtype=dt, device=dev)

    x = torch.zeros_like(b) if x0 is None else x0
    r0 = b - mv(x)
    beta = torch.sqrt(torch.clamp(torch.sum(r0 * r0), min=1e-300))
    n = b.shape[0]
    nblk = -(-restart // l)
    mtot = 1 + nblk * l

    # the basis, Gram and generators are filled in place, block by block
    Z = torch.zeros((mtot, n), dtype=dt, device=dev)
    Z[0] = r0 / beta
    G = torch.zeros((mtot, mtot), dtype=dt, device=dev)
    G[0, 0] = 1.0
    # generator bookkeeping: theta * Z[k+1] = A @ (Z^T Y[:, k])
    Y = torch.zeros((mtot, nblk * l), dtype=dt, device=dev)
    E = torch.zeros((mtot, nblk * l), dtype=dt, device=dev)
    hist = []
    for blk in range(nblk):
        mcur = 1 + blk * l
        # coefficient-space CGS of the newest column against the previous
        e = _unit(mtot, mcur - 1, b)
        if mcur > 1:
            coef = _clipped_solve(G[:mcur - 1, :mcur - 1],
                                  G[:mcur - 1, mcur - 1])
            e[:mcur - 1] = e[:mcur - 1] - coef
        nrm = torch.sqrt(torch.clamp(e @ G @ e, min=1e-300))
        q_coef = e / nrm
        g = q_coef @ Z
        # l theta-scaled powers; generators recorded for the final LS
        for k in range(l):
            idx = mcur + k
            g = mv(g) / theta
            Y[:, idx - 1] = q_coef if k == 0 else _unit(mtot, idx - 1, b)
            E[idx, idx - 1] = theta
            Z[idx] = g
        # ONE reduction: the Gram rows of the l new columns
        dots = Z[:mcur + l] @ Z[mcur:mcur + l].T   # (mcur+l, l)
        G[:mcur + l, mcur:mcur + l] = dots
        G[mcur:mcur + l, :mcur + l] = dots.T
        # block-end residual from the Gram-metric LS (small matrices)
        mnow = mcur + l
        c0 = torch.zeros((mnow,), dtype=dt, device=dev)
        c0[0] = beta
        _, res = _gram_solve(G[:mnow, :mnow], E[:mnow, :blk * l + l], c0)
        hist.append(res)

    c0 = torch.zeros((mtot,), dtype=dt, device=dev)
    c0[0] = beta
    t, res = _gram_solve(G, E, c0)
    # row scaling (left Jacobi) leaves the solution variables unchanged
    x_final = x + (Y @ t) @ Z
    hist = torch.repeat_interleave(torch.stack(hist), l)[:nblk * l]
    return SolveResult(x=x_final,
                       iters=torch.tensor(nblk * l, dtype=torch.int32,
                                          device=dev),
                       res_norm=res, res_history=hist)
