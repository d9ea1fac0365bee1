"""Lilliefors normality test (Eqs. 10-11), applied to log-runtimes to test
log-normality as in Section 4.2 of the paper.

    Z_i = (ln X_i - xbar) / s,    T = sup_x |F(x) - S(x)|

with F the standard normal cdf and S the empirical cdf of the Z_i.
Critical values: classical Lilliefors table (alpha = 0.05) for n <= 30,
asymptotic 0.886/sqrt(n) beyond (Rigdon & Basu, the paper's ref [18]);
Monte-Carlo option for exactness.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.stats.cramer_von_mises import TestResult
from repro_torch.core.stats.ecdf import as_samples

_TABLE_05 = {
    4: 0.375, 5: 0.343, 6: 0.323, 7: 0.304, 8: 0.288, 9: 0.274, 10: 0.262,
    11: 0.251, 12: 0.242, 13: 0.234, 14: 0.226, 15: 0.219, 16: 0.213,
    17: 0.207, 18: 0.202, 19: 0.197, 20: 0.192, 25: 0.173, 30: 0.159,
}


def _phi(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))


def lilliefors_statistic(samples) -> float:
    """sup-norm distance between the N(0,1) cdf and the ecdf of the
    standardized samples (two-sided Kolmogorov form)."""
    z = torch.sort(as_samples(samples)).values
    n = z.shape[0]
    z = (z - z.mean()) / z.std(correction=1)
    F = _phi(z)
    i = torch.arange(1, n + 1, dtype=torch.float64)
    d_plus = torch.max(i / n - F)
    d_minus = torch.max(F - (i - 1) / n)
    return float(torch.maximum(d_plus, d_minus))


def critical_value_05(n: int) -> float:
    """alpha = 0.05 Lilliefors critical value for sample size ``n``.

    Classical table (with linear interpolation) for 4 <= n <= 30;
    asymptotic 0.886/sqrt(n) beyond; 1.0 (never reject) for n < 4.
    """
    if n in _TABLE_05:
        return _TABLE_05[n]
    if n < 4:
        return 1.0
    if n < 30:
        ks = sorted(_TABLE_05)
        lo = max(k for k in ks if k <= n)
        hi = min(k for k in ks if k >= n)
        w = (n - lo) / (hi - lo)
        return (1 - w) * _TABLE_05[lo] + w * _TABLE_05[hi]
    return 0.886 / math.sqrt(n)


def lilliefors(samples, *, log: bool = False, alpha: float = 0.05,
               mc: int = 0, seed: int = 0) -> TestResult:
    """Lilliefors normality test (Eqs. 10-11).

    ``log=True`` tests LOG-normality of the raw (positive) samples, the
    paper's Section 4.2 usage.  ``mc`` > 0 replaces the table by a
    Monte-Carlo critical value from ``mc`` standard-normal resamples of
    the same size, drawn through a ``torch.Generator`` seeded with
    ``seed``.  ``reject=True`` means (log-)normality is rejected.
    """
    x = as_samples(samples)
    if log:
        x = torch.log(x)
    t = lilliefors_statistic(x)
    n = x.shape[0]
    if mc > 0:
        gen = torch.Generator().manual_seed(seed)
        stats = torch.tensor([lilliefors_statistic(torch.randn(
            n, generator=gen, dtype=torch.float64)) for _ in range(mc)],
            dtype=torch.float64)
        crit = float(torch.quantile(stats, 1.0 - alpha))
        method = "mc"
    else:
        crit = critical_value_05(n)
        method = "table"
    return TestResult(statistic=t, modified_statistic=t, critical_value=crit,
                      reject=bool(t > crit), alpha=alpha, method=method)
