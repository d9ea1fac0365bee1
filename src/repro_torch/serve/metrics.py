"""Latency statistics for the serving drivers (a copy of the JAX package's
``serve/metrics.py``: ``percentile`` and ``LatencyStats``).

The acceptance metric is TAIL latency (p50/p99/p999), not the mean.  The
solver-serving summaries of the same module (``ServeStats``,
``summarize``) come with the serving layer (ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

QUANTILES = (0.5, 0.99, 0.999)


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolated quantile of ``samples`` (numpy semantics)."""
    return float(np.quantile(np.asarray(samples, float), q))


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Quantile summary of one latency sample set (seconds)."""

    n: int
    mean: float
    p50: float
    p99: float
    p999: float
    max: float

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "LatencyStats":
        """Summarize a non-empty latency sample vector."""
        a = np.asarray(samples, float)
        return cls(n=int(a.size), mean=float(a.mean()),
                   p50=percentile(a, 0.5), p99=percentile(a, 0.99),
                   p999=percentile(a, 0.999), max=float(a.max()))

    def as_dict(self) -> Dict[str, float]:
        """Plain-dict form (JSON/report friendly)."""
        return dataclasses.asdict(self)
