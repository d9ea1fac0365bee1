"""Asymptotic speedup E[T]/E[T'] -> E[max_p T_p] / mu (§3.1).

  uniform on [0,b]:  2P/(P+1)            (< 2 always, §3.2)
  exponential:       H_P                 (> 2 for P >= 4; 25/12 at P=4, §3.3)
  log-normal(0,1):   ~1.5205 at P=2, ~2.2081 at P=4 (numerical, §3.4)
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.perfmodel.distributions import Distribution
from repro_torch.core.perfmodel.expected_max import expected_max, harmonic


def asymptotic_speedup(dist: Distribution, P: int, method: str = "auto",
                       device="cuda") -> float:
    """Speedup of the pipelined (no-synchronization) variant as K -> inf.

    The ratio E[max of P iid draws] / E[draw] (paper Eq. 8); ``method`` and
    ``device`` are forwarded to ``expected_max``.
    """
    return expected_max(dist, P, method=method, device=device) \
        / float(dist.mean)


def uniform_speedup(P: int, a: float = 0.0, b: float = 1.0) -> float:
    """Closed-form §3.2 speedup for Uniform(a, b): 2(a + Pb)/((P+1)(a+b))."""
    return 2.0 * (a + P * b) / ((P + 1) * (a + b))


def exponential_speedup(P: int) -> float:
    """Closed-form §3.3 speedup for Exponential waits: the harmonic sum H_P."""
    return harmonic(P)


def speedup_table(dist: Distribution, Ps: Sequence[int],
                  method: str = "auto", device="cuda") -> Dict[int, float]:
    """``{P: asymptotic_speedup(dist, P)}`` over a grid of process counts."""
    return {P: asymptotic_speedup(dist, P, method=method, device=device)
            for P in Ps}


def min_procs_exceeding(dist: Distribution, bound: float = 2.0,
                        pmax: int = 1 << 20, device="cuda") -> int:
    """Smallest process count P whose asymptotic speedup exceeds ``bound``.

    P is scanned densely up to 16, then geometrically.  Returns -1 if the
    speedup never exceeds ``bound`` up to ``pmax``.
    """
    P = 2
    while P <= pmax:
        if asymptotic_speedup(dist, P, device=device) > bound:
            return P
        P += 1 if P < 16 else P // 4
    return -1
