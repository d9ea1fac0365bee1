"""Resolve campaign noise names to Distribution objects + fast sampling.

Names:
  ``uniform``       -> Uniform(0, 1)
  ``exponential``   -> Exponential(lam=1)
  ``lognormal``     -> LogNormal(mu=0, sigma=1)
  ``trace:<ALG>``   -> EmpiricalDistribution of Table-1 calibrated runs
                       (ALG in GMRES / PGMRES / CG / PIPECG)

``sample_np`` / ``scale_distribution`` (re-exported from
``core/noise/sampling.py``) draw with a host numpy Generator: native
samplers for the closed-form families, inverse-CDF interpolation for
traces.  A trace's recorded runs are drawn by the port's
``trace_distribution`` with a torch generator on ``device`` (the card
unless the caller asks for the CPU), so they are not the JAX package's
numpy draws: compare trace-driven results by their statistics.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.noise.sampling import (  # noqa: F401  (campaign API)
    sample_np,
    scale_distribution,
)
from repro_torch.core.noise.traces import trace_distribution
from repro_torch.core.perfmodel.distributions import (
    Distribution,
    Exponential,
    LogNormal,
    Uniform,
)

# expected best-fit family per noise name (the fitting round-trip check);
# recorded traces are base + exponential accumulation by construction.
INJECTED_FAMILY: Dict[str, str] = {
    "uniform": "uniform",
    "exponential": "exponential",
    "lognormal": "lognormal",
}


def make_distribution(name: str, seed: int = 0,
                      device="cuda") -> Distribution:
    """Resolve a campaign noise name to a ``Distribution`` instance
    (``device`` is where a trace's runs are drawn)."""
    if name == "uniform":
        return Uniform(0.0, 1.0)
    if name == "exponential":
        return Exponential(1.0)
    if name == "lognormal":
        return LogNormal(0.0, 1.0)
    if name.startswith("trace:"):
        return trace_distribution(name.split(":", 1)[1], seed=seed,
                                  device=device)
    raise KeyError(f"unknown noise {name!r}; known: uniform, exponential, "
                   "lognormal, trace:<ALG>")


def injected_family(name: str) -> Optional[str]:
    """Distribution family the fitting stage is expected to recover.

    Recorded traces return ``None``: a trace is its own (empirical)
    distribution, so the round-trip check does not apply; the composite
    goodness-of-fit tests are powerful enough at campaign sample sizes to
    distinguish a 256-point interpolated trace from any closed family.
    """
    if name.startswith("trace:"):
        return None
    return INJECTED_FAMILY[name]
