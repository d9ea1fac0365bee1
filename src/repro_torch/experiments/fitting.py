"""Campaign fitting stage: distribution identification on collected samples
(the JAX package's ``experiments/fitting.py`` over the port's ``core/stats``).

Wraps the ``core/stats`` pipeline (MLE fits -> Lilliefors / Cramer-von
Mises acceptance, exactly the paper's §4) and adds the campaign's
round-trip classification: which of the candidate families best explains
the samples, to be compared against the family that was *injected*.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.stats import FitReport, fit_report
from repro_torch.core.stats.mle import fit_lognormal


def classify_family(rep: FitReport) -> str:
    """Best-fit family among uniform / exponential / lognormal.

    Candidates are the families whose goodness-of-fit test does NOT reject
    at alpha=0.05; ties break on the smallest statistic-to-critical-value
    ratio.  Returns ``"none"`` when every family is rejected.
    """
    ratios = {
        "uniform": rep.uniform.modified_statistic / rep.uniform.critical_value,
        "exponential": (rep.exponential.modified_statistic
                        / rep.exponential.critical_value),
        "lognormal": (rep.lognormal.modified_statistic
                      / rep.lognormal.critical_value),
    }
    accepted = {k: v for k, v in ratios.items()
                if not getattr(rep, k).reject}
    if not accepted:
        return "none"
    return min(accepted, key=accepted.get)


def fit_cell(samples, name: str = "") -> Dict:
    """Full fitting record for one sample set.

    Returns the Table-1 summary statistics, per-family test verdicts
    (True = REJECT at alpha=0.05), the classified best family, and the
    fitted parameters of each family (uniform a/b, shifted-exponential
    loc/lambda, lognormal mu/sigma).
    """
    x = np.asarray(samples, np.float64)
    rep = fit_report(x, name=name)
    exp_fit = rep.exponential.fitted          # Shifted(Exponential, loc)
    uni_fit = rep.uniform.fitted
    ln_fit = fit_lognormal(x)
    return {
        "name": name,
        "summary": rep.summary,
        "verdicts": rep.verdicts(),
        "best_family": classify_family(rep),
        "params": {
            "uniform": {"a": float(uni_fit.a), "b": float(uni_fit.b)},
            "exponential": {"loc": float(exp_fit.loc),
                            "lambda": float(exp_fit.base.lam)},
            "lognormal": {"mu": float(ln_fit.mu),
                          "sigma": float(ln_fit.sigma)},
        },
        "statistics": {
            "uniform": {"T": float(rep.uniform.modified_statistic),
                        "crit": float(rep.uniform.critical_value)},
            "exponential": {"T": float(rep.exponential.modified_statistic),
                            "crit": float(rep.exponential.critical_value)},
            "lognormal": {"T": float(rep.lognormal.modified_statistic),
                          "crit": float(rep.lognormal.critical_value)},
        },
    }


def recovered_params(cell: Dict, family: str) -> Optional[Dict[str, float]]:
    """Fitted parameters of ``family`` from a ``fit_cell`` record."""
    return cell["params"].get(family)
