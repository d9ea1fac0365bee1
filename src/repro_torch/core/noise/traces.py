"""Recorded noise traces as distributions.

``EmpiricalDistribution`` lets a recorded trace (run times, or the waits a
NoiseHook injected) flow through the same sampling, E[max] and speedup
machinery as the closed-form families of the paper's Section 3.  The rest
of the reference module (the Table-1 calibrated run generator) comes with
the campaign (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.perfmodel.distributions import Distribution


@dataclasses.dataclass(frozen=True)
class EmpiricalDistribution(Distribution):
    """Distribution backed by recorded samples (a noise *trace*).

    Quantiles interpolate the empirical quantile function; the CDF is the
    right-continuous ECDF.  ``samples`` must be a sorted 1-D tuple of
    floats (use ``from_samples``); units are whatever the trace was
    recorded in.
    """

    samples: tuple = ()
    trace_name: str = "trace"
    name: ClassVar[str] = "empirical"

    @staticmethod
    def from_samples(x, trace_name: str = "trace") -> "EmpiricalDistribution":
        """Build from any array-like of recorded values (sorts a copy)."""
        xs = np.sort(np.asarray(x, np.float64))
        return EmpiricalDistribution(samples=tuple(float(v) for v in xs),
                                     trace_name=trace_name)

    def _xs(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.samples, dtype=torch.float64,
                            device=like.device)

    def cdf(self, x):
        """Right-continuous ECDF: #(samples <= x) / n."""
        x = torch.as_tensor(x, dtype=torch.float64)
        xs = self._xs(x)
        return torch.searchsorted(xs, x, right=True) / len(self.samples)

    def quantile(self, u):
        """Linear interpolation of the empirical quantile function.

        ``np.interp`` semantics: clamped to the first and last sample
        outside the grid ``(i - 0.5) / n``.
        """
        u = torch.as_tensor(u, dtype=torch.float64)
        xs = self._xs(u)
        n = len(self.samples)
        grid = (torch.arange(1, n + 1, dtype=torch.float64,
                             device=u.device) - 0.5) / n
        if n == 1:
            return torch.full_like(u, float(xs[0]))
        j = torch.clamp(torch.searchsorted(grid, u, right=True), 1, n - 1)
        g0, g1, x0, x1 = grid[j - 1], grid[j], xs[j - 1], xs[j]
        t = torch.clamp((u - g0) / (g1 - g0), 0.0, 1.0)
        return x0 + t * (x1 - x0)

    @property
    def mean(self):
        """Sample mean of the trace."""
        return float(np.mean(self.samples))
