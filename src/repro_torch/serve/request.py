"""Solve requests and their serve-side records.

A :class:`SolveRequest` is one (operator, b, tol, deadline) unit of work
submitted to the serving layer; batching COMPATIBILITY is decided by
:func:`group_key` (same operator family/shape/dtype + preconditioner +
inner product: what one cached batch step can express) and by
:func:`content_key` (group key + the operator's actual coefficients: what
one in-flight batch can share, since every RHS column multiplies the SAME
bands).  Both keys equal the JAX package's for the same operator and b.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.krylov.operators import DiaMatrix

# where operator_fingerprint memoises a digest on the operator object
_FP_MEMO = "_serve_fingerprint"


@dataclasses.dataclass
class SolveRequest:
    """One queued solve: ``A x = b`` to ``tol`` before ``deadline_s``.

    ``b`` is a numpy array or a tensor on the operator's device.
    ``arrival_s`` is the request's arrival time on the server clock
    (seconds since serve start; the open-loop load generator stamps it,
    interactive submission leaves 0.0 = available immediately).
    ``deadline_s`` is RELATIVE to arrival; ``math.inf`` = best-effort.

    ``options`` (a :class:`~repro_torch.core.krylov.options.SolverOptions`)
    is the typed way to set ``maxiter`` / ``tol`` / ``M``; it cannot be
    mixed with the loose equivalents, and fields the serve path cannot
    honor per-request (``engine``: a server-level choice, noise hooks,
    depth, rr, non-default precision) raise instead of being silently
    dropped.  The unpacked values land on the plain fields, so
    ``group_key`` / batching are options-agnostic.
    """

    rid: int
    A: DiaMatrix
    b: Any
    tol: float = 1e-8
    deadline_s: float = math.inf
    maxiter: int = 500
    arrival_s: float = 0.0
    M: Optional[str] = None      # None (identity) | "jacobi"
    ip: str = "id"               # "id" -> PIPECG, "A" -> PIPECR
    options: Optional[object] = None

    def __post_init__(self):
        if self.options is not None:
            from repro_torch.core.krylov.options import SolverOptions
            if not isinstance(self.options, SolverOptions):
                raise TypeError("options= must be a SolverOptions; got "
                                f"{type(self.options).__name__}")
            loose = [name for name, value, default in
                     (("tol", self.tol, 1e-8), ("maxiter", self.maxiter, 500),
                      ("M", self.M, None)) if value != default]
            if loose:
                raise TypeError(
                    "pass the solve configuration either as options= or "
                    "as loose kwargs, not both (options= given alongside "
                    f"{sorted(loose)})")
            for field, bad, hint in (
                    ("engine", self.options.engine is not None,
                     "a server-level choice: SolverServer(options=...)"),
                    ("noise", self.options.noise is not None,
                     "serve injects faults via ServeChaos"),
                    ("depth", self.options.depth != 1,
                     "the batched step is depth-1"),
                    ("rr/rr_tau",
                     bool(self.options.rr or self.options.rr_tau),
                     "serve re-glues via quarantine restarts"),
                    ("precision", not self.options.precision.is_default,
                     "the single-device batched path runs at the solve "
                     "dtype")):
                if bad:
                    raise ValueError(
                        f"SolveRequest cannot honor options.{field}: "
                        f"{hint}")
            self.tol = float(self.options.tol)
            self.maxiter = int(self.options.maxiter)
            self.M = self.options.M
        if self.M not in (None, "jacobi"):
            raise ValueError("serve supports M in {None, 'jacobi'}; "
                             "callable preconditioners cannot be batched")
        if self.ip not in ("id", "A"):
            raise ValueError("ip must be 'id' (PIPECG) or 'A' (PIPECR)")


def dtype_name(b) -> str:
    """numpy's name of ``b``'s dtype ("float64"), for arrays and tensors
    alike and without copying a tensor off its device."""
    if isinstance(b, torch.Tensor):
        return str(b.dtype).removeprefix("torch.")
    return np.dtype(np.asarray(b).dtype).name


def group_key(req: SolveRequest) -> Tuple:
    """Compile-compatibility key: requests sharing it share one cached
    batch step.

    The structural part comes from the operator protocol
    (``SparseOperator.structure_key``: format tag + shape parameters, no
    coefficients) so DIA and BSR operators of identical global size can
    never share a batch step.
    """
    A = req.A
    skey = (tuple(A.structure_key()) if hasattr(A, "structure_key")
            else tuple(A.offsets))
    return (skey, int(A.n), dtype_name(req.b), req.M, req.ip)


def _coefficient_stamp(attrs: dict) -> Tuple:
    """Identity, storage and in-place version of each coefficient tensor
    of an operator's attributes: it changes when a tensor is swapped or
    written in place."""
    return tuple((id(t), t.data_ptr(), t._version)
                 for t in attrs.values() if isinstance(t, torch.Tensor))


def operator_fingerprint(A) -> str:
    """Digest of the operator coefficients (batch-sharing identity).

    Delegates to the operator protocol (``SparseOperator.fingerprint``,
    the JAX package's hex for the same coefficients) once per operator:
    the digest is memoised on the object, stamped with its coefficient
    tensors' identity and version, so the queue's scans never re-hash
    (and never copy to the host) bands that did not change.  Raw objects
    without the protocol get the legacy inline digest over
    ``(offsets, bands)``.
    """
    if not hasattr(A, "fingerprint"):
        h = hashlib.sha1()
        h.update(repr(tuple(A.offsets)).encode())
        h.update(np.ascontiguousarray(np.asarray(A.bands)).tobytes())
        return h.hexdigest()[:16]
    attrs = getattr(A, "__dict__", None)
    if attrs is None:       # no instance dict to hold a memo
        return A.fingerprint()
    stamp = _coefficient_stamp(attrs)
    memo = attrs.get(_FP_MEMO)
    if memo is not None and memo[0] == stamp:
        return memo[1]
    fp = A.fingerprint()
    # a frozen dataclass: the memo goes into the instance dict directly
    attrs[_FP_MEMO] = (stamp, fp)
    return fp


def content_key(req: SolveRequest) -> Tuple:
    """Batch-compatibility key: group key + operator coefficients."""
    return group_key(req) + (operator_fingerprint(req.A),)


@dataclasses.dataclass
class ServeRecord:
    """The serve-side answer to one request (solution + latency breakdown).

    ``x`` is a host numpy copy of the solution.  Block indices
    (``*_block``) count batch steps since serve start: they are
    DETERMINISTIC (independent of wall-clock jitter), which is what the
    starvation-bound tests pin; the ``*_s`` fields are the wall-clock
    story the latency benchmarks report.
    """

    rid: int
    x: np.ndarray
    iters: int
    res_norm: float
    converged: bool
    arrival_s: float
    admitted_s: float
    finished_s: float
    deadline_s: float = math.inf
    restarts: int = 0
    arrival_block: int = 0
    admitted_block: int = 0
    finished_block: int = 0

    @property
    def latency_s(self) -> float:
        """End-to-end sojourn: finish - arrival."""
        return self.finished_s - self.arrival_s

    @property
    def wait_s(self) -> float:
        """Queueing delay: admission - arrival."""
        return self.admitted_s - self.arrival_s
