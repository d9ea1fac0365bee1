"""Section 2: the deterministic model and the 2x folk theorem.

Eq. (1): T  = sum_k max_p (c_p + w_p) = K max_p T_p   (synchronized)
Eq. (2): T' = max_p sum_k (c_p + w_p) = K max_p T_p   (pipelined)
=> deterministic, stationary times admit NO speedup at all.

Eq. (5): one delay W per process, staggered: speedup (2+alpha)/(1+alpha)
<= 2 with alpha = K T0 / W; extended to P processes the bound is P.

Schedules are float64 tensors, (K, P): step k of process p.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def deterministic_makespans(per_process_times: Sequence[float],
                            K: int) -> Tuple[float, float]:
    """Eq. (1)/(2) for constant per-process step times: (T, T')."""
    t = torch.as_tensor(per_process_times, dtype=torch.float64)
    return float(K * torch.max(t)), float(torch.max(K * t))


def trace_makespans(times: torch.Tensor) -> Tuple[float, float]:
    """times (K, P): an explicit schedule.  Returns (T, T')."""
    return (float(torch.sum(torch.max(times, dim=1).values)),
            float(torch.max(torch.sum(times, dim=0))))


def staggered_delay_trace(W: float, T0: float, K: int, P: int = 2,
                          device="cuda") -> torch.Tensor:
    """Process p waits W on step p (p < K), T0 otherwise (Figs. 3-4), on
    ``device`` (the card unless the caller asks for the CPU)."""
    times = torch.full((K, P), float(T0), dtype=torch.float64, device=device)
    for p in range(min(P, K)):
        times[p, p] = W
    return times


def folk_bound(P: int = 2) -> float:
    """Upper bound on overlap-only speedup: P (= 2 for compute/comm)."""
    return float(P)


def overlap_speedup_bound(alpha: float) -> float:
    """Eq. (5): (2+alpha)/(1+alpha), alpha = K T0 / W."""
    return (2.0 + alpha) / (1.0 + alpha)
