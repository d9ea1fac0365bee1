"""Pluggable iteration engines: WHO executes a solver iteration's vector work.

* ``NaiveEngine`` — plain torch ops, one op per AXPY/dot/SpMV.
* ``FusedEngine`` — kernel-backed.  For a DIA operator with identity or
  Jacobi preconditioning a whole PIPECG iteration (8 updates + M-apply +
  SpMV + the fused reduction) is ONE kernel sweep
  (kernels/pipecg_spmv_fused.py); otherwise it falls back to the
  update-only kernel (kernels/pipecg_fused.py) with explicit operator /
  preconditioner applications.  Operator applications outside the sweep
  go through the DIA SpMV kernel (kernels/spmv_dia.py).
* ``ShardedFusedEngine`` — registered so the name resolves, but the
  distributed solve it belongs to is not ported yet: it raises.

Loop invariants (diag^-1, the ABFT column sums ``c = A^T 1``, the resolved
preconditioner) are computed once per solve by :meth:`Engine.prepare` and
handed to every :meth:`Engine.pipecg_iter` call: eager torch would
otherwise pay a full pass for each of them every iteration.

Engines are selected per solve via ``engine="naive" | "fused"`` (or an
Engine instance); ``engine=None`` keeps the inline code paths of cg.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.core.krylov.operators import DiaMatrix

ENGINES: Dict[str, "Engine"] = {}

# operator formats whose fused single-sweep kernel exists
_SWEEP_FORMATS = ("dia",)


def register_engine(cls):
    """Class decorator: instantiate + register under ``cls.name``."""
    ENGINES[cls.name] = cls()
    return cls


def get_engine(engine: Union[str, "Engine", None]) -> Optional["Engine"]:
    """Resolve an engine selector (name / instance / None) to an Engine."""
    if engine is None or isinstance(engine, Engine):
        return engine
    try:
        return ENGINES[engine]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; registered: {sorted(ENGINES)}"
        ) from None


def sweep_ok(A, M) -> bool:
    """True when the single-sweep kernel can run A with M in-kernel.

    M may be None (identity) or "jacobi"; callables are opaque.
    """
    return (getattr(A, "format", None) in _SWEEP_FORMATS
            and (M is None or (isinstance(M, str) and M == "jacobi")))


def _resolve_M(A, M) -> Callable:
    if M is None:
        return lambda z: z
    if isinstance(M, str) and M == "jacobi":
        inv_d = 1.0 / A.diagonal()
        return lambda z: inv_d * z
    return M


def _reject_bsr(A) -> None:
    if getattr(A, "format", None) == "bsr":
        raise NotImplementedError(
            "BSR operators need the blocked-ELL kernels, which are not "
            "ported yet (ROADMAP.md queue 2, items 8-9)")


@dataclasses.dataclass
class IterOperands:
    """Loop invariants of one solve (see module docstring).

    ``inv_diag`` is set only on the single-sweep path; ``csum`` is None
    for an opaque operator (no structure to checksum).
    """

    A: Any
    Mf: Callable
    inv_diag: Optional[torch.Tensor] = None
    csum: Optional[torch.Tensor] = None


class Engine:
    """Iteration-engine interface.

    ``pipecg_init`` returns a dict of state vectors plus the first
    (gamma, delta); ``prepare`` returns the solve's loop invariants;
    ``pipecg_iter`` advances the state by one iteration and returns
    ``(vecs, gamma, delta, rr, aux)`` where ``aux`` holds ``chk`` (the
    ABFT checksum residual ``1^T w - c^T u``) and ``ww`` (``<w, w>``).
    """

    name = "abstract"

    def spmv(self, A, x):
        raise NotImplementedError

    def precond(self, A, M, r):
        return _resolve_M(A, M)(r)

    def prepare(self, A, M, dtype) -> IterOperands:
        csum = (A.column_checksum().to(dtype)
                if hasattr(A, "column_checksum") else None)
        return IterOperands(A=A, Mf=_resolve_M(A, M), csum=csum)

    def _init10(self, A, b, x0, M, ip):
        """Initial 10-vector PIPECG state (x, r, u, w, m, n, z, q, s, p)."""
        Mf = _resolve_M(A, M)
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - self.spmv(A, x)
        u = Mf(r)
        w = self.spmv(A, u)
        gamma = _rdot(r, u) if ip == "id" else _rdot(r, w)
        delta = _rdot(w, u) if ip == "id" else _rdot(w, w)
        m = Mf(w)
        n_ = self.spmv(A, m)
        zero = torch.zeros_like(b)
        vecs = dict(x=x, r=r, u=u, w=w, m=m, n=n_,
                    z=zero, q=zero, s=zero, p=zero)
        return vecs, gamma, delta

    def pipecg_init(self, A, b, x0, M, ip: str):
        raise NotImplementedError

    def pipecg_iter(self, ops: IterOperands, ip: str, vecs, alpha, beta):
        raise NotImplementedError


def _ip_pick(ip: str, ru, wu, rw, ww):
    """(gamma, delta) from the five fused partials."""
    return (ru, wu) if ip == "id" else (rw, ww)


def _rdot(a, b):
    """Row-wise dot: 0-d for (n,) operands, (k,) for batched (k, n)."""
    return torch.sum(a * b, dim=-1)


def _abft_chk(ops: IterOperands, u, w):
    """Signed ABFT checksum residual ``1^T w - c^T u`` (``c = A^T 1``).

    One reduction over ``w - c*u``, as the reference takes it; zeros for an
    opaque operator so detectors see a never-tripping channel.
    """
    if ops.csum is not None:
        return torch.sum(w - ops.csum * u, dim=-1)
    return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)


def _pipecg10_step(eng: Engine, ops: IterOperands, ip, z, q, s, p, x, r, u,
                   w, red=None):
    """Finish a 10-vector iteration after the updates: dots, M-apply, SpMV."""
    if red is not None and ip == "id":
        gamma, delta = red[..., 0], red[..., 1]
    else:
        gamma = _rdot(r, u) if ip == "id" else _rdot(r, w)
        delta = _rdot(w, u) if ip == "id" else _rdot(w, w)
    rr = red[..., 2] if red is not None else _rdot(r, r)
    m = ops.Mf(w)
    n_ = eng.spmv(ops.A, m)
    aux = dict(chk=_abft_chk(ops, u, w), ww=_rdot(w, w))
    return (dict(x=x, r=r, u=u, w=w, m=m, n=n_, z=z, q=q, s=s, p=p),
            gamma, delta, rr, aux)


@register_engine
class NaiveEngine(Engine):
    """Reference engine: every AXPY / dot / SpMV is a separate torch op."""

    name = "naive"

    def spmv(self, A, x):
        return A.matvec(x) if hasattr(A, "matvec") else A(x)

    def pipecg_init(self, A, b, x0, M, ip):
        return self._init10(A, b, x0, M, ip)

    def pipecg_iter(self, ops, ip, st, alpha, beta):
        alpha = alpha[..., None] if alpha.dim() else alpha
        beta = beta[..., None] if beta.dim() else beta
        z = st["n"] + beta * st["z"]
        q = st["m"] + beta * st["q"]
        s = st["w"] + beta * st["s"]
        p = st["u"] + beta * st["p"]
        x = st["x"] + alpha * p
        r = st["r"] - alpha * s
        u = st["u"] - alpha * q
        w = st["w"] - alpha * z
        return _pipecg10_step(self, ops, ip, z, q, s, p, x, r, u, w)


@register_engine
class FusedEngine(Engine):
    """Kernel-backed engine: minimal device-memory sweeps per iteration."""

    name = "fused"

    def spmv(self, A, x):
        _reject_bsr(A)
        if isinstance(A, DiaMatrix):
            from repro_torch.kernels import ops as kops
            return kops.spmv_dia_step(A.offsets, A.bands, x)
        return A.matvec(x) if hasattr(A, "matvec") else A(x)

    def prepare(self, A, M, dtype):
        _reject_bsr(A)
        if not sweep_ok(A, M):
            return super().prepare(A, M, dtype)
        # dtype follows the OPERATOR: under a storage-demoting policy the
        # operator, diag^-1 and c ride at the storage dtype the kernel
        # streams, while x stays at the accumulator dtype
        if M is None:
            inv_d = torch.ones((A.n,), dtype=A.dtype, device=A.device)
        else:
            inv_d = (1.0 / A.diagonal()).to(A.dtype).contiguous()
        return IterOperands(A=A, Mf=_resolve_M(A, M), inv_diag=inv_d,
                            csum=A.column_checksum().contiguous())

    def pipecg_init(self, A, b, x0, M, ip):
        _reject_bsr(A)
        if not sweep_ok(A, M):
            # fallback: update-kernel path carries the full 10-vector state
            return self._init10(A, b, x0, M, ip)
        Mf = _resolve_M(A, M)
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - self.spmv(A, x)
        u = Mf(r)
        w = self.spmv(A, u)
        gamma = _rdot(r, u) if ip == "id" else _rdot(r, w)
        delta = _rdot(w, u) if ip == "id" else _rdot(w, w)
        # single-sweep path: only (x, r, u, p) round-trip device memory
        return dict(x=x, r=r, u=u, p=torch.zeros_like(b)), gamma, delta

    def pipecg_iter(self, ops, ip, st, alpha, beta):
        from repro_torch.kernels import ops as kops

        A = ops.A
        if "w" not in st:  # single-sweep state
            x, r, u, p, red = kops.pipecg_spmv_fused_step(
                A.offsets, A.bands, ops.inv_diag, ops.csum,
                st["x"], st["r"], st["u"], st["p"], alpha, beta)
            gamma, delta = _ip_pick(ip, red[..., 0], red[..., 1],
                                    red[..., 3], red[..., 4])
            # checksum residual 1^T w' - c^T u' rode the same sweep (col 5)
            aux = dict(chk=red[..., 5], ww=red[..., 4])
            return dict(x=x, r=r, u=u, p=p), gamma, delta, red[..., 2], aux

        # two-sweep fallback: fused updates+dots, then M-apply + SpMV
        (x, r, u, w, z, q, s, p, red) = kops.pipecg_fused_step(
            st["x"], st["r"], st["u"], st["w"], st["m"], st["n"],
            st["z"], st["q"], st["s"], st["p"], alpha, beta)
        return _pipecg10_step(self, ops, ip, z, q, s, p, x, r, u, w,
                              red=red)


@register_engine
class ShardedFusedEngine(Engine):
    """Distributed single-sweep engine: not ported yet, so it raises."""

    name = "sharded_fused"

    def _reject(self, *_args, **_kw):
        raise NotImplementedError(
            "engine='sharded_fused' runs the per-rank halo sweep under "
            "distributed_solve, which this package does not have yet "
            "(ROADMAP.md queue 1, item 5 and queue 2, item 4)")

    spmv = prepare = pipecg_init = pipecg_iter = _reject
