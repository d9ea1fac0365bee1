"""Common solver machinery: result container, local dot, matvec coercion."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class SolveResult(NamedTuple):
    """Solver output: solution, iteration count, residual norm + history.

    ``detect_history`` (optional) carries the per-iteration ABFT detector
    values of the solve (the in-kernel SpMV checksum residual on the
    engine paths); ``None`` for solver paths that carry no detector.
    Batched solves give ``x`` (k, n), ``iters`` / ``res_norm`` (k,) and
    ``res_history`` (k, maxiter).
    """

    x: torch.Tensor
    iters: torch.Tensor           # number of iterations performed
    res_norm: torch.Tensor        # final ||r||_2 of the recurrence
    res_history: torch.Tensor     # per-iteration residual norms (maxiter,)
    detect_history: Optional[torch.Tensor] = None  # ABFT detector values


def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-device inner product (the paper's "local computation")."""
    return torch.sum(a * b)


def as_matvec(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """Normalize an operator (callable or ``.matvec`` object) to a callable."""
    if callable(A):
        return A
    return A.matvec
