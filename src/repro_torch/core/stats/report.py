"""Distribution-fitting report: the full Section 4.3 pipeline on a set of
run times: the Table-1 row (summary statistics), the CvM uniform and
exponential decisions and the Lilliefors log-normal decision, i.e. one
column of Table 1 plus the Fig. 5/6 verdicts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.stats.cramer_von_mises import (TestResult,
                                                     cramer_von_mises)
from repro_torch.core.stats.ecdf import as_samples, ecdf
from repro_torch.core.stats.lilliefors import lilliefors
from repro_torch.core.stats.mle import FITTERS, summary_statistics


@dataclasses.dataclass
class FitReport:
    """One Table-1 column: summary statistics + the four test outcomes.

    ``exponential`` is the physically-motivated shifted (two-parameter)
    fit; ``exponential_origin`` the paper's literal lambda = 1/xbar fit.
    """

    name: str
    summary: Dict[str, float]
    uniform: TestResult
    exponential: TestResult          # shifted (two-parameter) exponential
    exponential_origin: TestResult   # the paper's literal lambda = 1/xbar
    lognormal: TestResult

    def verdicts(self) -> Dict[str, bool]:
        """True = REJECT at alpha = 0.05."""
        return {"uniform": self.uniform.reject,
                "exponential": self.exponential.reject,
                "lognormal": self.lognormal.reject}

    def table_row(self) -> str:
        s = self.summary
        return (f"{self.name:10s} xbar={s['mean']:.4f} med={s['median']:.4f} "
                f"s={s['s']:.4f} s2={s['s2']:.4f} lam={s['lambda']:.4f} "
                f"min={s['min']:.4f} max={s['max']:.4f}")

    def verdict_row(self) -> str:
        v = self.verdicts()

        def fmt(r):
            return "reject" if r else "accept"
        return (f"{self.name:10s} uniform={fmt(v['uniform'])} "
                f"exponential={fmt(v['exponential'])} "
                f"lognormal={fmt(v['lognormal'])}")


def fit_report(samples, name: str = "") -> FitReport:
    """Run the Section 4.3 identification pipeline on one sample set.

    Uses the paper's tabulated critical values with plug-in estimation for
    every family, to match the paper's decisions; a bootstrap critical
    value is :func:`cramer_von_mises` with ``bootstrap=`` and ``seed=``.
    """
    x = as_samples(samples)
    return FitReport(
        name=name,
        summary=summary_statistics(x),
        uniform=cramer_von_mises(x, "uniform"),
        exponential=cramer_von_mises(x, "exponential_shifted"),
        exponential_origin=cramer_von_mises(x, "exponential"),
        lognormal=lilliefors(x, log=True),
    )


def ecdf_with_fits(samples):
    """(x, F_emp, {family: F_fit(x)}) for Fig. 5/6 style output."""
    x, F = ecdf(samples)
    return x, F, {fam: fitter(x).cdf(x) for fam, fitter in FITTERS.items()}
