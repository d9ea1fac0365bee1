"""Latency/throughput statistics for the serving layers (a copy of the JAX
package's ``serve/metrics.py``).

The acceptance metric is TAIL latency (p50/p99/p999), not the mean; the
quantile names match ``core/perfmodel/queueing.py`` so measured and
modeled rows line up.  ``LatencyStats`` serves both the LM serving loop
(``launch/serve.py``) and the solver server (``serve/server.py``), whose
end-of-run summary is :class:`ServeStats`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

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


@dataclasses.dataclass
class ServeStats:
    """End-of-run summary of one solver-server run (serve_exec's rows)."""

    n_requests: int
    n_converged: int
    wall_s: float
    throughput_rps: float
    occupancy_mean: float
    latency: LatencyStats
    wait: LatencyStats
    deadline_met_frac: float
    restarts: int
    drained: bool

    def as_dict(self) -> Dict:
        """Plain-dict form (JSON/report friendly)."""
        d = dataclasses.asdict(self)
        d["latency"] = self.latency.as_dict()
        d["wait"] = self.wait.as_dict()
        return d


def occupancy_mean(per_block_active: Sequence[int], k_slots: int) -> float:
    """Mean fraction of busy batch slots over the busy blocks."""
    a = np.asarray(per_block_active, float)
    if a.size == 0:
        return 0.0
    return float(a.mean() / k_slots)


def summarize(records: List, k_slots: int,
              per_block_active: Sequence[int],
              wall_s: float, drained: bool) -> ServeStats:
    """Build :class:`ServeStats` from finished :class:`ServeRecord` s."""
    lat = [r.latency_s for r in records]
    wait = [r.wait_s for r in records]
    met = [bool(r.latency_s <= r.deadline_s) for r in records]
    return ServeStats(
        n_requests=len(records),
        n_converged=sum(1 for r in records if r.converged),
        wall_s=wall_s,
        throughput_rps=(len(records) / wall_s if wall_s > 0 else 0.0),
        occupancy_mean=occupancy_mean(per_block_active, k_slots),
        latency=LatencyStats.from_samples(lat or [0.0]),
        wait=LatencyStats.from_samples(wait or [0.0]),
        deadline_met_frac=(sum(met) / len(met) if met else 1.0),
        restarts=sum(r.restarts for r in records),
        drained=drained,
    )
