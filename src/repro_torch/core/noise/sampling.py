"""Host-side (numpy) sampling and scaling of waiting-time distributions.

The wall-clock injection hook draws on the host: native numpy samplers for
the closed-form families, inverse-CDF interpolation for recorded traces,
and a generic quantile transform (the distribution's torch ``quantile`` on
CPU doubles) for the rest, so no draw touches the card on the measured
critical path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.noise.traces import EmpiricalDistribution
from repro_torch.core.perfmodel.distributions import (
    Distribution,
    Exponential,
    LogNormal,
    Uniform,
)


def sample_np(dist: Distribution, rng: np.random.Generator,
              shape) -> np.ndarray:
    """Draw ``shape`` samples from ``dist`` with a host numpy Generator."""
    if isinstance(dist, Uniform):
        return rng.uniform(dist.a, dist.b, size=shape)
    if isinstance(dist, Exponential):
        return rng.exponential(1.0 / dist.lam, size=shape)
    if isinstance(dist, LogNormal):
        return rng.lognormal(dist.mu, dist.sigma, size=shape)
    if isinstance(dist, EmpiricalDistribution):
        xs = np.asarray(dist.samples, np.float64)
        n = xs.shape[0]
        grid = (np.arange(1, n + 1) - 0.5) / n
        return np.interp(rng.uniform(size=shape), grid, xs)
    # generic inverse-CDF fallback: the torch quantile on CPU doubles
    u = rng.uniform(1e-12, 1.0, size=shape)
    q = dist.quantile(torch.from_numpy(np.asarray(u, np.float64)))
    return np.asarray(q.to(torch.float64).cpu().numpy(), np.float64)


def scale_distribution(dist: Distribution, s: float) -> Distribution:
    """Distribution of ``s * W`` for ``W ~ dist`` (s in seconds/unit).

    Converts dimensionless waiting-time draws into seconds before they are
    combined with the phase model's compute/reduction times.
    """
    if isinstance(dist, Uniform):
        return Uniform(dist.a * s, dist.b * s)
    if isinstance(dist, Exponential):
        return Exponential(dist.lam / s)
    if isinstance(dist, LogNormal):
        return LogNormal(dist.mu + float(np.log(s)), dist.sigma)
    if isinstance(dist, EmpiricalDistribution):
        return EmpiricalDistribution(
            samples=tuple(v * s for v in dist.samples),
            trace_name=dist.trace_name)
    raise TypeError(f"cannot scale {type(dist).__name__}")
