"""Online ABFT detectors + adaptive residual replacement (Cools-style).

1. **In-kernel checksum** (kernels/checksum.py): every fused sweep emits
   the SpMV checksum residual ``1^T(Av) - c^T v`` (``c = A^T 1``) as an
   extra entry of its reduction row.
2. **Deviation recursion**: an online estimator of the gap
   ``||b - A x_i - r_i||`` between the true and recurrence residuals,
   ``dev' = dev + eps (||r|| + 2 |alpha| ||w||)``, built from norms the
   fused reduction already carries.  Crossing ``tau * ||r||`` triggers
   adaptive residual replacement (cg.py ``rr_tau``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: default headroom factor between the rounding floor and the trip level
DEFAULT_TAU = 1e3


def machine_eps(dtype) -> float:
    """Unit roundoff of ``dtype`` (the recursion's per-step increment)."""
    return float(torch.finfo(dtype).eps)


def checksum_threshold(scale, n: int, dtype, tau: float = DEFAULT_TAU):
    """Trip level for a checksum/state-deviation residual.

    ``scale`` must be an ABSOLUTE-value magnitude of the compared sums
    (e.g. ``sum |(Av)_i| + sum |c_j v_j|``).  The floor is the summation
    rounding model ``eps * sqrt(n) * scale``; ``tau`` is the headroom.
    """
    return tau * machine_eps(dtype) * float(np.sqrt(max(n, 1))) * scale


def deviation_update(dev, alpha, rr2, ww, *, eps: float):
    """One step of the Cools-style residual-gap recursion (estimator).

    ``rr2 = <r, r>`` and ``ww = <w, w>`` come from the carried fused
    reduction; ``alpha`` is the step's scalar.
    """
    return dev + eps * (torch.sqrt(torch.clamp(rr2, min=0.0))
                        + 2.0 * torch.abs(alpha)
                        * torch.sqrt(torch.clamp(ww, min=0.0)))


def deviation_trip(dev, rr2, tau: float):
    """True when the estimated gap crosses ``tau * ||r||`` (replace now)."""
    return dev > tau * torch.sqrt(torch.clamp(rr2, min=0.0))


@dataclasses.dataclass
class DetectionReport:
    """Provenance record of one detector verdict on one solve (segment).

    ``detector`` names the fast path that produced the verdict
    ("checksum", "deviation", "state_deviation", "history_jump") or the
    slow path ("true_residual"); ``confirmed`` records the slow-path
    confirm outcome when one ran (None = not consulted).
    """

    solver: str
    detector: str
    tripped: bool
    trip_iter: int = -1            # -1 = never tripped
    value: float = 0.0             # detector value at the trip (or max)
    threshold: float = 0.0
    tau: float = DEFAULT_TAU
    action: str = "none"           # none | replace | rollback | quarantine
    confirmed: Optional[bool] = None
