"""Statistical identification of the noise distribution (paper Section 4).

Usage::

    >>> from repro_torch.core.stats import fit_report
    >>> rep = fit_report(run_times_seconds, name="PIPECG")
    >>> rep.verdicts()          # {"uniform": True (=reject), ...}
    >>> rep.summary["lambda"]   # 1/mean, the paper's Table-1 column

Samples may be numpy arrays, sequences or tensors on any device; every
function works on float64 CPU tensors (:func:`ecdf.as_samples`), the form
the distributions' ``cdf`` and ``quantile`` take here.
"""
from repro_torch.core.stats.cramer_von_mises import (  # noqa: F401
    TestResult,
    cramer_von_mises,
    cvm_statistic,
)
from repro_torch.core.stats.ecdf import as_samples, ecdf, ecdf_at  # noqa: F401
from repro_torch.core.stats.lilliefors import (  # noqa: F401
    lilliefors,
    lilliefors_statistic,
)
from repro_torch.core.stats.mle import (  # noqa: F401
    FITTERS,
    fit_exponential,
    fit_exponential_shifted,
    fit_lognormal,
    fit_uniform,
    summary_statistics,
)
from repro_torch.core.stats.report import (  # noqa: F401
    FitReport,
    ecdf_with_fits,
    fit_report,
)
