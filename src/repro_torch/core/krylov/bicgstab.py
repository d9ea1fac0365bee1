"""BiCGStab for non-symmetric systems, classical and pipelined.

Classical BiCGStab has FOUR synchronization points per iteration (rho,
<r_hat, v>, <t, s>, <t, t>), twice CG's.  ``pipebicgstab`` (Cools &
Vanroose's pipelined recurrences) fuses them into ONE (6, 6) Gram
reduction per iteration over the carried basis ``[r, w, t, a, c, r_hat]``:
the auxiliary chains ``w = A r``, ``t = A w``, ``s = A p``, ``z = A s`` and
``v = A z`` ride by recurrence, so an iteration needs the classical two
SpMVs, and alpha, beta and omega unwind from the Gram matrix carried from
the previous iteration (:func:`pbicgstab_scalars`).  The reduction issued
at the end of iteration i is consumed only by iteration i+1's scalar
recurrence: the split-phase window that core/perfmodel/sync.py prices.

Preconditioning is RIGHT preconditioning by operator substitution
(``A_hat = A M``): residuals are TRUE residuals of ``A x = b`` and the
solution maps back as ``x = M y``.  ``M = "jacobi"`` folds diag^-1 into the
DIA bands as column scaling, so the fused kernel preconditions for free;
a callable M must be linear.

Fixed-trip semantics, as the reference's ``lax.scan``: every solve runs
``maxiter`` steps, a converged system is frozen by a masked update
(``torch.where``) AT the iterate whose residual met the tolerance (BiCGStab
is not monotone), ``res_history`` has length ``maxiter`` and ``iters``
counts the steps before the freeze.  The loop runs in Python and the
scalars stay on the device as 0-d tensors; only ``rr_tau > 0`` reads a
flag on the host once per iteration.  ``engine="fused"`` with a DIA
operator and M None or "jacobi" runs each iteration as one kernel sweep
(kernels/pipebicgstab_fused.py); the sharded split-phase path is
core/krylov/distributed.py::sharded_pipebicgstab_solve.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.krylov import abft
from repro_torch.core.krylov.base import SolveResult, as_matvec, local_dot
from repro_torch.core.krylov.cg import _history, _norm
from repro_torch.core.krylov.engine import (FusedEngine, ShardedFusedEngine,
                                            _resolve_M, get_engine)
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import (UNSET, check_supported,
                                             resolve_options)

# Gram-basis index convention shared with the kernel and the sharded path:
# V = [r, w, t, a, c, r_hat]
GRAM_R, GRAM_W, GRAM_T, GRAM_A, GRAM_C, GRAM_RHAT = range(6)


def _eps(dtype) -> float:
    """The solvers' breakdown guard added to every denominator."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def bicgstab(A, b, x0=None, *, maxiter=UNSET, tol=UNSET, M=UNSET,
             dot=local_dot, engine=UNSET, options=None) -> SolveResult:
    """Preconditioned BiCGStab (fixed trip count, masked freeze).

    ``engine`` ("naive" / "fused" / Engine / None) routes the SpMV and
    preconditioner applications through an iteration engine; None keeps
    the inline path, which also honours a custom ``dot`` (e.g. the
    all-reduce dot of ``distributed_solve``).
    """
    opts = resolve_options(options, maxiter=maxiter, tol=tol, M=M,
                           engine=engine)
    check_supported(opts, "bicgstab", supported=("engine",))
    maxiter, tol, M, engine = opts.maxiter, opts.tol, opts.M, opts.engine
    eng = get_engine(engine)
    if eng is not None:
        if dot is not local_dot:
            raise ValueError(
                "engine= computes local reductions and cannot honor a custom "
                "dot (e.g. a distributed dot); use engine=None there")
        mv = lambda v: eng.spmv(A, v)  # noqa: E731
        M = _resolve_M(A, M)
    else:
        mv = as_matvec(A)
    M = M if M is not None else (lambda z: z)
    x = torch.zeros_like(b) if x0 is None else x0

    r = b - mv(x)
    r_hat = r
    rho = dot(r_hat, r)
    st = dict(x=x, r=r, p=r, rho=rho, rr=dot(r, r),
              done=torch.zeros((), dtype=torch.bool, device=b.device),
              iters=torch.zeros((), dtype=torch.int32, device=b.device))
    tol2 = torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
        * dot(b, b)
    eps = _eps(b.dtype)
    hist = []
    for _ in range(maxiter):
        # the preconditioner is applied ONCE per vector and reused by the
        # x update
        Mp = M(st["p"])
        v = mv(Mp)
        alpha = st["rho"] / (dot(r_hat, v) + eps)          # sync 1
        s = st["r"] - alpha * v
        Ms = M(s)
        t = mv(Ms)
        omega = dot(t, s) / (dot(t, t) + eps)              # sync 2+3
        x = st["x"] + alpha * Mp + omega * Ms
        r = s - omega * t
        rho_new = dot(r_hat, r)                            # sync 4
        beta = (rho_new / (st["rho"] + eps)) * (alpha / (omega + eps))
        p = r + beta * (st["p"] - omega * v)
        rr = dot(r, r)
        done = st["done"] | (rr <= tol2)
        new = dict(x=x, r=r, p=p, rho=rho_new, rr=rr, done=done,
                   iters=st["iters"] + (~done).to(torch.int32))
        # once frozen, emit the FROZEN iterate's residual, so the history
        # tail is constant and equals res_norm
        hist.append(_norm(torch.where(st["done"], st["rr"], rr)))
        st = {k: torch.where(st["done"], st[k], nv) for k, nv in new.items()}
    return SolveResult(x=st["x"], iters=st["iters"], res_norm=_norm(st["rr"]),
                       res_history=_history(hist, b[..., 0]))


# ---------------------------------------------------------------------------
# Pipelined BiCGStab: one fused (6, 6) Gram reduction per iteration
# ---------------------------------------------------------------------------

def pbicgstab_scalars(G, rho_prev, alpha_prev, omega_prev, first, eps):
    """(rr, rho, alpha, beta, omega) from the fused Gram reduction.

    ``G`` is the (6, 6) (or (7, 6), checksum row ignored) Gram matrix of
    ``[r, w, t, a, c, r_hat]`` carried from the previous iteration.  All
    four classical inner products unwind from it: ``rho = <r, r_hat>`` and
    ``<s, r_hat> = <w, r_hat> + beta <a, r_hat>`` give alpha, and
    ``omega = <q, y> / <y, y>`` with ``q = r - alpha s``,
    ``y = w - alpha z``, ``z = t + beta c`` expands as a polynomial in
    alpha and beta over Gram entries.  ``first`` selects beta = 0 for the
    first iteration.
    """
    R, W, T, As, C, H = (GRAM_R, GRAM_W, GRAM_T, GRAM_A, GRAM_C, GRAM_RHAT)
    rr = G[R, R]
    rho = G[R, H]
    if first:
        beta = torch.zeros_like(rho)
    else:
        beta = (alpha_prev / (omega_prev + eps)) * (rho / (rho_prev + eps))
    s_rhat = G[W, H] + beta * G[As, H]
    alpha = rho / (s_rhat + eps)
    qy = (G[R, W] - alpha * (G[R, T] + G[W, W])
          - alpha * beta * (G[R, C] + G[W, As])
          + alpha ** 2 * (G[W, T] + beta * (G[W, C] + G[T, As])
                          + beta ** 2 * G[As, C]))
    yy = (G[W, W] - 2.0 * alpha * (G[W, T] + beta * G[W, C])
          + alpha ** 2 * (G[T, T] + 2.0 * beta * G[T, C]
                          + beta ** 2 * G[C, C]))
    omega = qy / (yy + eps)
    return rr, rho, alpha, beta, omega


def _gram6(vs: Tuple, dot) -> torch.Tensor:
    """(6, 6) Gram matrix of the basis tuple ``vs`` through ``dot``.

    For the plain local dot this is ONE fused matmul (the single-reduction
    payload); a custom ``dot`` is applied per unique entry.
    """
    if dot is local_dot:
        V = torch.stack(vs)
        return V @ V.T
    G = torch.zeros((6, 6), dtype=vs[0].dtype, device=vs[0].device)
    for i in range(6):
        for j in range(i, 6):
            d = dot(vs[i], vs[j])
            G[i, j] = d
            G[j, i] = d
    return G


def _right_preconditioned(A, M, b, x0):
    """(A_hat, mv_hat, unscale, y0) for right preconditioning A M y = b.

    ``M`` may be None, ``"jacobi"`` (DIA operators only; folded into the
    bands as column scaling) or a LINEAR callable (composed into the
    matvec; ``x0`` is rejected there because mapping it into y-space
    needs M^-1).  The solution maps back as ``x = unscale(y)``.
    """
    if M is None:
        return A, as_matvec(A), None, x0
    if isinstance(M, str) and M == "jacobi":
        if not isinstance(A, DiaMatrix):
            raise ValueError(
                "pipebicgstab M='jacobi' needs a DiaMatrix operator to "
                "derive the diagonal; pass a callable M otherwise")
        invd = 1.0 / A.diagonal()
        n, h = A.n, A.halo
        invd_ext = torch.nn.functional.pad(invd, (h, h))
        # A_hat[i, i+off] = A[i, i+off] * invd[i+off]  (column scaling)
        bands = [A.bands[k] * invd_ext[h + off:h + off + n]
                 for k, off in enumerate(A.offsets)]
        A_hat = DiaMatrix(offsets=A.offsets, bands=torch.stack(bands))
        y0 = None if x0 is None else x0 / invd
        return A_hat, A_hat.matvec, (lambda y: invd * y), y0
    if callable(M):
        if x0 is not None:
            raise ValueError(
                "pipebicgstab with a callable M is right-preconditioned "
                "(x = M y): an x0 cannot be mapped into y-space without "
                "M^-1; start from x0=None or use M='jacobi'")
        mv = as_matvec(A)
        return A, (lambda v: mv(M(v))), M, None
    raise ValueError(
        f"pipebicgstab M must be None, 'jacobi' or a linear callable, "
        f"got {M!r}")


def pipebicgstab(A, b, x0=None, *, maxiter=UNSET, tol=UNSET, M=UNSET,
                 dot=local_dot, engine=UNSET, rr=UNSET, rr_tau=UNSET,
                 gram_reduce: Optional[Callable] = None,
                 options=None) -> SolveResult:
    """Pipelined BiCGStab: one fused Gram reduction per iteration.

    Same surface as :func:`bicgstab` plus:

    rr:
        Residual-replacement period in iterations (0 = off): every ``rr``
        iterations r, w and t are recomputed from ``b - A_hat x``.  The
        trigger is known on the host, so only replacement iterations pay
        the three SpMVs and the extra reduction, on every path.
    rr_tau:
        Adaptive residual replacement (0 = off): the deviation recursion
        of core/krylov/abft.py over Gram entries the carried reduction
        already holds triggers the same replacement.  Reading the trigger
        is one host sync per iteration; the local reduction path only (a
        custom ``dot`` / ``gram_reduce`` raises).
    engine:
        None / "naive" keep the per-op recurrence (None also honours a
        custom ``dot``); "fused" runs the WHOLE iteration (updates,
        in-band Jacobi, both SpMVs, the Gram and the checksum row) as one
        kernel sweep for DIA operators with M None or "jacobi", and
        routes the SpMV of a callable M through the engine;
        "sharded_fused" must go through ``distributed_solve``.
    gram_reduce:
        Optional collective that finishes a locally computed partial
        (6, 6) Gram; the inline distributed path passes one all-reduce so
        the iteration keeps its single reduction there (a custom ``dot``
        alone would be applied per Gram entry).

    Iteration counts lag ``bicgstab`` by one: convergence is detected
    from the carried reduction, one iteration after the iterate froze.
    """
    opts = resolve_options(options, maxiter=maxiter, tol=tol, M=M,
                           engine=engine, rr=rr, rr_tau=rr_tau)
    check_supported(opts, "pipebicgstab",
                    supported=("engine", "rr", "rr_tau"))
    maxiter, tol, M = opts.maxiter, opts.tol, opts.M
    engine, rr, rr_tau = opts.engine, opts.rr, opts.rr_tau
    eng = get_engine(engine)
    if isinstance(eng, ShardedFusedEngine):
        raise ValueError(
            "engine='sharded_fused' computes per-rank partial reductions "
            "and must run on a process group: use distributed_solve("
            "pipebicgstab, A, b, group, engine='sharded_fused') instead")
    if eng is not None and dot is not local_dot:
        raise ValueError(
            "engine= computes local reductions and cannot honor a custom "
            "dot (e.g. a distributed dot); use engine=None there")

    A_hat, mv, unscale, y0 = _right_preconditioned(A, M, b, x0)
    use_kernel = (isinstance(eng, FusedEngine)
                  and isinstance(A_hat, DiaMatrix) and not callable(M))
    if eng is not None and not use_kernel:
        base = lambda v: eng.spmv(A_hat, v)  # noqa: E731
        # a callable M is NOT folded into A_hat: keep the composition and
        # route only the operator application through the engine
        mv = (lambda v: base(M(v))) if callable(M) else base

    if gram_reduce is None:
        gram = lambda vs: _gram6(vs, dot)  # noqa: E731
    else:
        # one stacked local matmul + ONE finishing collective
        def gram(vs):
            V = torch.stack(vs)
            return gram_reduce(V @ V.T)

    adaptive = float(rr_tau) > 0.0
    if adaptive and not (dot is local_dot and gram_reduce is None):
        raise ValueError(
            "rr_tau= (adaptive residual replacement) triggers on a "
            "data-dependent test and needs the local reduction path; on "
            "the distributed inline path (custom dot / gram_reduce) use rr=")

    dt = b.dtype
    y = torch.zeros_like(b) if y0 is None else y0
    r0 = b - mv(y)
    r_hat = r0
    w0 = mv(r0)
    t0 = mv(w0)
    zero = torch.zeros_like(b)
    eps = _eps(dt)
    one = torch.ones((), dtype=dt, device=b.device)
    csum = None
    if use_kernel:
        # the kernel emits a 7th row whose [0] entry is the ABFT checksum
        # residual 1^T t' - c^T w'; the carried G takes its (7, 6) shape,
        # seeded with the init basis' own checksum
        csum = A_hat.column_checksum().to(dt).contiguous()
        base_gram = gram

        def gram(vs):
            row = torch.zeros((1, 6), dtype=dt, device=b.device)
            row[0, 0] = torch.sum(vs[2]) - torch.sum(csum * vs[1])
            return torch.cat([base_gram(vs), row])
    st = dict(x=y, r=r0, w=w0, t=t0, pa=zero, a=zero, c=zero,
              G=gram((r0, w0, t0, zero, zero, r_hat)),
              rho_prev=one, alpha_prev=one, omega_prev=one,
              dev=torch.zeros((), dtype=dt, device=b.device),
              done=torch.zeros((), dtype=torch.bool, device=b.device),
              iters=torch.zeros((), dtype=torch.int32, device=b.device))
    tol2 = torch.as_tensor(tol, dtype=dt, device=b.device) ** 2 * dot(b, b)
    rr_period = int(rr)
    eps_u = abft.machine_eps(dt)
    hist, chk_hist = [], []
    for k in range(maxiter):
        # consume the reduction issued LAST iteration: its only consumers
        # are these scalar recurrences (the split-phase window)
        rr2, rho, alpha, beta, omega = pbicgstab_scalars(
            st["G"], st["rho_prev"], st["alpha_prev"], st["omega_prev"],
            k == 0, eps)
        if use_kernel:
            from repro_torch.kernels import ops as kops
            x, r, w, t, pa, a, c, G = kops.pipebicgstab_fused_step(
                A_hat.offsets, A_hat.bands, csum, st["x"], st["r"],
                st["w"], st["t"], st["pa"], st["a"], st["c"], r_hat,
                alpha, beta, omega)
        else:
            p = st["r"] + beta * st["pa"]
            s = st["w"] + beta * st["a"]
            z = st["t"] + beta * st["c"]
            v = mv(z)                                  # SpMV 1
            q = st["r"] - alpha * s
            yv = st["w"] - alpha * z
            x = st["x"] + alpha * p + omega * q
            r = q - omega * yv
            w = yv - omega * (st["t"] - alpha * v)
            t = mv(w)                                  # SpMV 2
            pa = p - omega * s
            a = s - omega * z
            c = z - omega * v
            # issue the NEXT iteration's fused reduction
            G = gram((r, w, t, a, c, r_hat))
        dev = st["dev"]
        if adaptive:
            # deviation recursion over carried Gram entries (no new dots)
            dev = abft.deviation_update(dev, alpha, rr2,
                                        st["G"][GRAM_W, GRAM_W], eps=eps_u)
        do_rr = bool(rr_period) and (k + 1) % rr_period == 0
        if adaptive and not do_rr:
            do_rr = bool(abft.deviation_trip(dev, rr2, rr_tau))
        if do_rr:
            # the 3 extra SpMVs and the Gram run only on replacement
            # iterations
            r = b - mv(x)
            w = mv(r)
            t = mv(w)
            G = gram((r, w, t, a, c, r_hat))
            dev = torch.zeros_like(dev)
        done = st["done"] | (rr2 <= tol2)
        # freeze AT the iterate whose (carried) residual met the
        # tolerance: BiCGStab is not monotone, so one more step could push
        # res_norm back above tol
        new = dict(x=x, r=r, w=w, t=t, pa=pa, a=a, c=c, G=G,
                   rho_prev=rho, alpha_prev=alpha, omega_prev=omega, dev=dev)
        iters = st["iters"] + (~done).to(torch.int32)
        if use_kernel:
            # the checksum row of the SAME carried Gram consumed above
            chk_hist.append(st["G"][6, 0])
        st = {key: torch.where(done, st[key], nv) for key, nv in new.items()}
        st.update(done=done, iters=iters)
        # rr2 comes from the CARRIED Gram: once frozen it is the frozen
        # iterate's own residual, so the emitted tail is constant
        hist.append(_norm(rr2))
    # final residual from the CARRIED Gram (bit-identical to the frozen
    # history tail), and the history rolled one slot so that
    # hist[i] = ||r_{i+1}||, the classical solvers' alignment
    res = _norm(st["G"][GRAM_R, GRAM_R])
    hist = _history(hist[1:] + [res] if maxiter else [], res)
    chk = None
    if use_kernel:
        chk = _history(chk_hist[1:] + [st["G"][6, 0]] if maxiter else [],
                       res)
    x_out = st["x"] if unscale is None else unscale(st["x"])
    return SolveResult(x=x_out, iters=st["iters"], res_norm=res,
                       res_history=hist, detect_history=chk)
