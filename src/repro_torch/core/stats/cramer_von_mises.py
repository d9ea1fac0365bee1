"""Cramer-von Mises goodness-of-fit test (Eq. 9 of the paper).

    T = 1/(12 n) + sum_i [ (2i-1)/(2n) - F(X_(i)) ]^2

The paper estimates distribution parameters from the sample (uniform via
min/max, exponential via MLE), which changes the null distribution of T.
Both the classical tabulated critical values (Stephens 1974-76, as
tabulated in Csorgo-Faraway / Rigdon-Basu, the paper's refs [17, 18]) and
a parametric-bootstrap critical value are provided.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.perfmodel.distributions import Distribution, uniforms
from repro_torch.core.stats.ecdf import as_samples
from repro_torch.core.stats.mle import FITTERS

# alpha = 0.05 critical values:
#   'known'       - fully specified F (asymptotic W^2 distribution)
#   'exponential' - parameters estimated, Stephens' modified statistic
#   'normal'      - parameters estimated (log-normal after the log)
CRITICAL_05 = {"known": 0.461, "exponential": 0.224, "normal": 0.126}


def cvm_statistic(samples, cdf: Callable) -> float:
    """Cramer-von Mises statistic T (Eq. 9) of ``samples`` against ``cdf``,
    any elementwise F on float64 tensors (a fitted ``Distribution.cdf``)."""
    x = torch.sort(as_samples(samples)).values
    n = x.shape[0]
    F = torch.as_tensor(cdf(x), dtype=torch.float64)
    i = torch.arange(1, n + 1, dtype=torch.float64)
    return float(1.0 / (12 * n) + torch.sum(((2 * i - 1) / (2 * n) - F) ** 2))


def _stephens_modified(t: float, n: int, case: str) -> float:
    """Stephens' small-sample modifications of W^2."""
    if case == "exponential":
        return t * (1.0 + 0.16 / n)
    if case == "known":
        return (t - 0.4 / n + 0.6 / n**2) * (1.0 + 1.0 / n)
    if case == "normal":
        return t * (1.0 + 0.5 / n)
    return t


@dataclasses.dataclass
class TestResult:
    """Outcome of one goodness-of-fit test.

    ``statistic`` is the raw T; ``modified_statistic`` applies Stephens'
    small-sample correction (equal to ``statistic`` when none applies);
    ``reject`` compares it against ``critical_value`` at level ``alpha``;
    ``method`` says how the critical value was obtained (table /
    bootstrap / mc); ``fitted`` is the plug-in distribution when
    parameters were estimated.
    """

    __test__ = False   # not a pytest class

    statistic: float
    modified_statistic: float
    critical_value: float
    reject: bool
    alpha: float
    method: str
    fitted: Optional[Distribution] = None


def cramer_von_mises(samples, family: str, alpha: float = 0.05,
                     bootstrap: int = 0, seed: int = 0) -> TestResult:
    """Composite CvM test: fit ``family`` (one of ``FITTERS``) by the
    paper's estimators, compute T (Eq. 9), compare against the alpha =
    0.05 critical value.

    ``bootstrap`` > 0 replaces the tabulated critical value by a
    parametric bootstrap with that many resamples, drawn through a
    ``torch.Generator`` seeded with ``seed``.  ``reject=True`` means the
    family is rejected at ``alpha``.
    """
    x = as_samples(samples)
    n = x.shape[0]
    fitted = FITTERS[family](x)
    t = cvm_statistic(x, fitted.cdf)

    if bootstrap > 0:
        gen = torch.Generator().manual_seed(seed)
        stats = torch.empty(bootstrap, dtype=torch.float64)
        for b in range(bootstrap):
            xb = fitted.quantile(uniforms(gen, (n,)))
            stats[b] = cvm_statistic(xb, FITTERS[family](xb).cdf)
        crit = float(torch.quantile(stats, 1.0 - alpha))
        return TestResult(statistic=t, modified_statistic=t,
                          critical_value=crit, reject=bool(t > crit),
                          alpha=alpha, method="bootstrap", fitted=fitted)

    case = {"uniform": "known", "exponential": "exponential",
            "exponential_shifted": "exponential",
            "lognormal": "normal"}[family]
    tm = _stephens_modified(t, n, case)
    crit = CRITICAL_05[case]
    return TestResult(statistic=t, modified_statistic=tm, critical_value=crit,
                      reject=bool(tm > crit), alpha=alpha, method="table",
                      fitted=fitted)
