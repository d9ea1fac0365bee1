"""CG / CR and their pipelined variants (PIPECG / PIPECR).

Classical CG has TWO global synchronization points per iteration, each of
which gates the very next vector update.  PIPECG (Ghysels & Vanroose,
Parallel Computing 40(7), 2014) rearranges the recurrences so the single
fused reduction (gamma, delta) of iteration i is consumed only AFTER the
SpMV + preconditioner application of the same iteration.  CR is CG in the
A-inner product (``ip="A"``).

Fixed-trip semantics, as the reference's ``lax.scan``: every solve runs
``maxiter`` steps, a converged system is frozen by a masked update
(``torch.where``), ``res_history`` has length ``maxiter`` and ``iters``
counts only the steps before the freeze.  The loop runs in Python, and
alpha/beta stay on the device: no iteration waits for the host, except
``rr_tau > 0`` whose "did any system trip" test needs one sync per
iteration.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.krylov import abft
from repro_torch.core.krylov.base import SolveResult, as_matvec, local_dot
from repro_torch.core.krylov.engine import (FusedEngine, _rdot, _resolve_M,
                                            get_engine, sweep_ok)
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import (UNSET, as_policy, check_supported,
                                             resolve_options)


def _ip_dots(ip: str, r, u, w, dot):
    """(gamma, delta) for the CG family.  ip='id' -> CG; ip='A' -> CR."""
    if ip == "id":
        return dot(r, u), dot(w, u)
    return dot(r, w), dot(w, w)


def _freeze(mask, new: dict, old: dict) -> dict:
    """Masked update: keep ``old`` where ``mask`` (converged) is set."""
    out = {}
    for key, nv in new.items():
        m = mask.reshape(mask.shape + (1,) * (nv.dim() - mask.dim()))
        out[key] = torch.where(m, old[key], nv)
    return out


def _history(values: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Stack per-step values to (maxiter,) or, batched, (k, maxiter)."""
    if not values:
        return like.new_empty(like.shape + (0,))
    h = torch.stack(values)
    return h.T if h.dim() == 2 else h


def _norm(rr):
    return torch.sqrt(torch.clamp(rr, min=0.0))


# ---------------------------------------------------------------------------
# Classical CG / CR (synchronizing)
# ---------------------------------------------------------------------------

def cg(A, b, x0=None, *, maxiter=UNSET, tol=UNSET, M=UNSET, dot=local_dot,
       ip: str = "id", engine=UNSET, options=None) -> SolveResult:
    """Preconditioned CG (ip='id') or CR (ip='A'), fixed trip count.

    ``options=SolverOptions(...)`` is the typed spelling of the knobs; the
    loose ``maxiter=/tol=/M=/engine=`` kwargs go through the deprecation
    shim.  ``engine`` ("naive" / "fused" / Engine / None) selects who runs
    the SpMV and preconditioner applications; None keeps the inline path.
    """
    opts = resolve_options(options, maxiter=maxiter, tol=tol, M=M,
                           engine=engine)
    check_supported(opts, "cg", supported=("engine",))
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
    u = M(r)
    w = mv(u)
    gamma, _ = _ip_dots(ip, r, u, w, dot)
    st = dict(x=x, r=r, u=u, w=w, p=u, s=w, gamma=gamma,
              done=torch.zeros((), dtype=torch.bool, device=b.device),
              iters=torch.zeros((), dtype=torch.int32, device=b.device))
    tol2 = torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
        * dot(b, b)
    hist = []
    for _ in range(maxiter):
        pAp = _ip_dots(ip, st["p"], st["p"], st["s"], dot)[1]
        alpha = st["gamma"] / pAp
        x = st["x"] + alpha * st["p"]
        r = st["r"] - alpha * st["s"]
        u = M(r)
        w = mv(u)
        gamma_new, _ = _ip_dots(ip, r, u, w, dot)
        beta = gamma_new / st["gamma"]
        p = u + beta * st["p"]
        s = w + beta * st["s"]
        rr = dot(r, r)
        done = st["done"] | (rr <= tol2)
        new = dict(x=x, r=r, u=u, w=w, p=p, s=s, gamma=gamma_new, done=done,
                   iters=st["iters"] + (~done).to(torch.int32))
        st = _freeze(st["done"], new, st)
        hist.append(_norm(rr))
    res = _norm(dot(st["r"], st["r"]))
    return SolveResult(x=st["x"], iters=st["iters"], res_norm=res,
                       res_history=_history(hist, b[..., 0]))


def cr(A, b, x0=None, **kw) -> SolveResult:
    """Conjugate Residuals: CG in the A-inner product (ip='A')."""
    kw.pop("ip", None)
    return cg(A, b, x0, ip="A", **kw)


# ---------------------------------------------------------------------------
# Pipelined CG / CR (split-phase reduction)
# ---------------------------------------------------------------------------

def pipecg(A, b, x0=None, *, maxiter=UNSET, tol=UNSET, M=UNSET,
           dot=local_dot, ip: str = "id", engine=UNSET, rr_tau=UNSET,
           precision=UNSET, options=None) -> SolveResult:
    """Ghysels-Vanroose pipelined CG (PIPECR via ip='A').

    Per iteration: ONE fused reduction (gamma, delta, ||r||^2) whose
    result is consumed only after the SpMV ``n = A m`` and the
    preconditioner ``m = M w``.

    ``engine`` ("naive" / "fused" / Engine / None) routes the iteration
    through an iteration engine (core/krylov/engine.py);
    ``engine="fused"`` with a DIA or BSR operator and identity/Jacobi M
    runs each iteration as ONE CUDA kernel sweep.  ``engine=None`` keeps the inline
    path.  ``rr_tau > 0`` enables adaptive residual replacement and
    ``precision`` (a PrecisionPolicy / preset name) demotes the carried
    basis and the operator to the storage dtype; both need an engine.
    """
    opts = resolve_options(options, maxiter=maxiter, tol=tol, M=M,
                           engine=engine, rr_tau=rr_tau, precision=precision)
    check_supported(opts, "pipecg",
                    supported=("engine", "rr_tau", "precision"))
    maxiter, tol, M = opts.maxiter, opts.tol, opts.M
    engine, rr_tau = opts.engine, opts.rr_tau
    if engine is not None:
        if dot is not local_dot:
            raise ValueError(
                "engine= computes local reductions and cannot honor a custom "
                "dot (e.g. a distributed dot); use engine=None there")
        return _pipecg_engine(A, b, x0, maxiter=maxiter, tol=tol, M=M,
                              ip=ip, engine=engine, rr_tau=rr_tau,
                              precision=opts.precision)
    if rr_tau:
        raise ValueError(
            "rr_tau= (adaptive residual replacement) needs the deviation "
            "recursion carried by an engine path; pass engine='naive' or "
            "'fused' (the inline engine=None path has no detector channel)")
    if not opts.precision.is_default:
        raise ValueError(
            "mixed-precision policies need an engine path (the storage "
            "demotion rides the DIA kernel sweeps): pass engine='fused'")
    mv = as_matvec(A)
    M = M if M is not None else (lambda z: z)
    x = torch.zeros_like(b) if x0 is None else x0

    r = b - mv(x)
    u = M(r)
    w = mv(u)
    gamma, delta = _ip_dots(ip, r, u, w, dot)
    m = M(w)
    n = mv(m)
    zero = torch.zeros_like(b)
    st = dict(x=x, r=r, u=u, w=w, m=m, n=n, z=zero, q=zero, s=zero, p=zero,
              gamma=gamma, delta=delta, gamma_prev=torch.ones_like(gamma),
              alpha_prev=torch.ones_like(gamma),
              done=torch.zeros((), dtype=torch.bool, device=b.device),
              iters=torch.zeros((), dtype=torch.int32, device=b.device))
    tol2 = torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
        * dot(b, b)
    hist = []
    for i in range(maxiter):
        gamma, delta = st["gamma"], st["delta"]
        if i == 0:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / st["gamma_prev"]
            alpha = gamma / (delta - beta * gamma / st["alpha_prev"])

        z = st["n"] + beta * st["z"]
        q = st["m"] + beta * st["q"]
        s = st["w"] + beta * st["s"]
        p = st["u"] + beta * st["p"]
        x = st["x"] + alpha * p
        r = st["r"] - alpha * s
        u = st["u"] - alpha * q
        w = st["w"] - alpha * z

        # ---- split-phase reduction: initiated here ... ----
        gamma_new, delta_new = _ip_dots(ip, r, u, w, dot)
        rr = dot(r, r)
        # ---- ... overlapped with M-apply + SpMV ... -------
        m = M(w)
        n = mv(m)
        # ---- ... consumed only at the NEXT iteration. -----

        done = st["done"] | (rr <= tol2)
        new = dict(x=x, r=r, u=u, w=w, m=m, n=n, z=z, q=q, s=s, p=p,
                   gamma=gamma_new, delta=delta_new, gamma_prev=gamma,
                   alpha_prev=alpha, done=done,
                   iters=st["iters"] + (~done).to(torch.int32))
        st = _freeze(st["done"], new, st)
        hist.append(_norm(rr))
    res = _norm(dot(st["r"], st["r"]))
    return SolveResult(x=st["x"], iters=st["iters"], res_norm=res,
                       res_history=_history(hist, b[..., 0]))


def pipecr(A, b, x0=None, **kw) -> SolveResult:
    """Pipelined CR: the PIPECG rearrangement in the A-inner product."""
    kw.pop("ip", None)
    return pipecg(A, b, x0, ip="A", **kw)


# ---------------------------------------------------------------------------
# Engine-driven PIPECG (single- and multi-RHS)
# ---------------------------------------------------------------------------

def _pipecg_scalars(st, first: bool):
    """(alpha, beta) from the carried fused-reduction results, on device."""
    gamma, delta = st["gamma"], st["delta"]
    if first:
        return gamma / delta, torch.zeros_like(gamma)
    beta = gamma / st["gamma_prev"]
    alpha = gamma / (delta - beta * gamma / st["alpha_prev"])
    return alpha, beta


def _select(t, nv, ov):
    """``nv`` where the per-system flag ``t`` is set, else ``ov``."""
    return torch.where(t.reshape(t.shape + (1,) * (nv.dim() - t.dim())),
                       nv, ov)


def _pipecg_engine(A, b, x0=None, *, maxiter=100, tol=0.0, M=None,
                   ip: str = "id", engine="naive", rr_tau: float = 0.0,
                   precision=None) -> SolveResult:
    """PIPECG with the vector work delegated to an iteration engine.

    Same scalar recurrences and masked-freeze semantics as the inline
    ``pipecg``; only WHO performs the AXPYs/dots/SpMV differs.  The
    engine's ``aux`` side-channel (checksum residual) is recorded per
    iteration as ``detect_history``; ``<w, w>`` drives the adaptive
    residual replacement when ``rr_tau > 0``.

    A storage-demoting ``precision`` policy keeps TWO operators: the exact
    ``A`` for init and re-glue, and ``A_iter`` with bands in the storage
    dtype for the per-iteration sweep.  The kernel's accumulator is
    ``x.dtype``.
    """
    policy = as_policy(precision)
    eng = get_engine(engine)
    A_iter = A
    sdt = None
    if not policy.is_default:
        if policy.wire != "fp32" or policy.wire_gram != "fp32":
            raise ValueError(
                "int8 wire compression applies to halo/reduction payloads "
                "of distributed solves; local engine paths have no wire")
        if not isinstance(A, DiaMatrix):
            raise ValueError(
                "precision storage demotion rides the DIA band stream; "
                "wrap the operator as a DiaMatrix (matrix-free operators "
                "have no resident operand to demote)")
        sdt = policy.storage_dtype
        if sdt is not None:
            A_iter = DiaMatrix(offsets=A.offsets, bands=A.bands.to(sdt))
    vecs, gamma, delta = eng.pipecg_init(A, b, x0, M, ip)
    if sdt is not None:
        if "w" in vecs:
            raise ValueError(
                "precision storage demotion needs the single-sweep fused "
                "path: engine='fused' with a DIA operator and M=None or "
                "'jacobi' (the 10-vector fallback state is accum-only)")
        # x stays at accum width; the carried basis rides at storage width
        vecs = dict(vecs, r=vecs["r"].to(sdt), u=vecs["u"].to(sdt),
                    p=vecs["p"].to(sdt))
    ops = eng.prepare(A_iter, M, b.dtype)
    one = torch.ones_like(gamma)
    st = dict(vecs=vecs, gamma=gamma, delta=delta, gamma_prev=one,
              alpha_prev=one, dev=torch.zeros_like(gamma),
              done=torch.zeros(gamma.shape, dtype=torch.bool,
                               device=b.device),
              iters=torch.zeros(gamma.shape, dtype=torch.int32,
                                device=b.device))
    tol2 = torch.as_tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
        * torch.sum(b * b, dim=-1)
    eps = abft.machine_eps(b.dtype)

    def _reglue(vecs_in):
        """Recompute r = b - A x, u = M r (+ images for 10-vector state).

        Runs against the EXACT operator at accum precision, then casts the
        replacement vectors back to the carried storage dtype.
        """
        r2 = b - eng.spmv(A, vecs_in["x"])
        u2 = eng.precond(A, M, r2)
        w2 = eng.spmv(A, u2)
        rep = dict(vecs_in, r=r2.to(vecs_in["r"].dtype),
                   u=u2.to(vecs_in["u"].dtype))
        if "w" in vecs_in:   # 10-vector states carry operator images too
            m2 = eng.precond(A, M, w2)
            s2 = eng.spmv(A, vecs_in["p"])
            q2 = eng.precond(A, M, s2)
            rep.update(w=w2, m=m2, n=eng.spmv(A, m2),
                       s=s2, q=q2, z=eng.spmv(A, q2))
        g2 = _rdot(r2, u2) if ip == "id" else _rdot(r2, w2)
        d2 = _rdot(w2, u2) if ip == "id" else _rdot(w2, w2)
        return rep, g2, d2, _rdot(r2, r2)

    hist, chk_hist = [], []
    for i in range(maxiter):
        alpha, beta = _pipecg_scalars(st, first=(i == 0))
        vecs, gamma_new, delta_new, rr, aux = eng.pipecg_iter(
            ops, ip, st["vecs"], alpha, beta)
        dev = st["dev"]
        if rr_tau > 0.0:
            dev = abft.deviation_update(dev, alpha, rr, aux["ww"], eps=eps)
            trip = abft.deviation_trip(dev, rr, rr_tau) & ~st["done"]
            # pay the re-glue SpMVs only when some system trips; reading
            # the flag is the one host sync per iteration of this path
            if bool(trip.any()):
                rep, g2, d2, rr2 = _reglue(vecs)
                vecs = {k: _select(trip, rep[k], v) for k, v in vecs.items()}
                gamma_new = _select(trip, g2, gamma_new)
                delta_new = _select(trip, d2, delta_new)
                rr = _select(trip, rr2, rr)
                dev = torch.where(trip, torch.zeros_like(dev), dev)
        done = st["done"] | (rr <= tol2)
        mask = st["done"]
        if not policy.is_default:
            # breakdown guard: a demoted recurrence that decays past its
            # attainable floor loses gamma positivity; freeze at the last
            # good iterate instead of propagating inf/nan
            bad = ~(torch.isfinite(alpha) & torch.isfinite(gamma_new)
                    & torch.isfinite(delta_new) & torch.isfinite(rr))
            mask = mask | bad
            done = done | bad
        frozen = _freeze(mask, dict(vecs, gamma=gamma_new, delta=delta_new,
                                    gamma_prev=st["gamma"],
                                    alpha_prev=alpha, dev=dev),
                         dict(st["vecs"], gamma=st["gamma"],
                              delta=st["delta"],
                              gamma_prev=st["gamma_prev"],
                              alpha_prev=st["alpha_prev"], dev=st["dev"]))
        st = dict(vecs={k: frozen[k] for k in vecs},
                  gamma=frozen["gamma"], delta=frozen["delta"],
                  gamma_prev=frozen["gamma_prev"],
                  alpha_prev=frozen["alpha_prev"], dev=frozen["dev"],
                  done=done,
                  iters=st["iters"] + (~done).to(torch.int32))
        hist.append(_norm(rr))
        chk_hist.append(aux["chk"])
    r = st["vecs"]["r"].to(b.dtype)
    res = _norm(torch.sum(r * r, dim=-1))
    return SolveResult(x=st["vecs"]["x"], iters=st["iters"], res_norm=res,
                       res_history=_history(hist, gamma),
                       detect_history=_history(chk_hist, gamma))


def pipecg_multi(A, B, X0=None, *, maxiter=100, tol=0.0, M=None,
                 ip: str = "id", engine="fused",
                 rr_tau: float = 0.0, precision=None) -> SolveResult:
    """Batched PIPECG: solve A x_j = b_j for every row of ``B`` (k, n).

    With ``engine="fused"`` and a DIA or BSR operator the k systems share
    one kernel sweep per iteration (the kernel's grid.y); each RHS keeps its
    own alpha/beta trajectory.  Other engines solve the rows one by one,
    as the reference's ``vmap`` over the single-RHS iteration does.

    Returns a SolveResult with x (k, n), res_norm (k,), iters (k,),
    res_history (k, maxiter).
    """
    eng = get_engine(engine)
    kw = dict(maxiter=maxiter, tol=tol, M=M, ip=ip, engine=eng,
              rr_tau=rr_tau, precision=precision)
    if isinstance(eng, FusedEngine) and sweep_ok(A, M):
        return _pipecg_engine(A, B, X0, **kw)
    sols = [_pipecg_engine(A, B[j], None if X0 is None else X0[j], **kw)
            for j in range(B.shape[0])]
    return SolveResult(*(torch.stack([getattr(s, f) for s in sols])
                         for f in SolveResult._fields))
