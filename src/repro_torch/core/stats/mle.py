"""Parameter estimation used by the paper's tests (Sections 4.1-4.2).

uniform      : a = X_min, b = X_max  (the paper's choice)
exponential  : MLE lambda = n / sum(X) = 1/mean
log-normal   : mu = mean(ln X), sigma = std(ln X)  (MLE)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.perfmodel.distributions import (
    Exponential,
    LogNormal,
    Shifted,
    Uniform,
)
from repro_torch.core.stats.ecdf import as_samples


def fit_uniform(x) -> Uniform:
    """Uniform(a, b) by the paper's plug-in: a = X_min, b = X_max (the
    parameters carry the samples' time unit)."""
    x = as_samples(x)
    return Uniform(a=float(x.min()), b=float(x.max()))


def fit_exponential(x) -> Exponential:
    """One-parameter exponential MLE: lambda = n / sum(X) = 1/mean (the
    paper's literal Section 4.1 estimator, origin at zero)."""
    return Exponential(lam=float(1.0 / as_samples(x).mean()))


def fit_exponential_shifted(x) -> Shifted:
    """Two-parameter exponential MLE: loc = X_min, lambda = 1/(mean - min).

    Run times have an irreducible compute floor, so the shifted family is
    the physically meaningful null."""
    x = as_samples(x)
    loc = float(x.min())
    scale = float(x.mean() - loc)
    return Shifted(base=Exponential(lam=1.0 / max(scale, 1e-12)), loc=loc)


def fit_lognormal(x) -> LogNormal:
    """Log-normal MLE: mu = mean(ln X), sigma = sample std of ln X
    (ddof 1, the Lilliefors standardization of Section 4.2); x > 0."""
    lx = torch.log(as_samples(x))
    return LogNormal(mu=float(lx.mean()), sigma=float(lx.std(correction=1)))


FITTERS = {"uniform": fit_uniform, "exponential": fit_exponential,
           "exponential_shifted": fit_exponential_shifted,
           "lognormal": fit_lognormal}


def summary_statistics(x) -> Dict[str, float]:
    """The paper's Table 1 rows: mean, median, s, s^2, lambda, min, max."""
    x = as_samples(x)
    return {
        "mean": float(x.mean()),
        # numpy's median: the middle pair's mean for even n
        "median": float(torch.quantile(x, 0.5)),
        "s": float(x.std(correction=1)),
        "s2": float(x.var(correction=1)),
        "lambda": float(1.0 / x.mean()),
        "min": float(x.min()),
        "max": float(x.max()),
        "n": int(x.shape[0]),
    }
