"""Stochastic performance model for pipelined Krylov methods (paper core).

Usage::

    >>> from repro_torch.core.perfmodel import Exponential, asymptotic_speedup
    >>> asymptotic_speedup(Exponential(1.0), P=4)     # H_4 = 25/12 > 2
    >>> from repro_torch.core.perfmodel import simulate
    >>> simulate(Exponential(1.0), P=8, K=1000).speedup_of_means  # on the card
"""
from repro_torch.core.perfmodel.distributions import (  # noqa: F401
    Deterministic,
    Distribution,
    Exponential,
    Gamma,
    LogNormal,
    Pareto,
    Shifted,
    Uniform,
)
from repro_torch.core.perfmodel.expected_max import (  # noqa: F401
    expected_max,
    expected_max_closed,
    expected_max_mc,
    expected_max_quad,
    harmonic,
)
from repro_torch.core.perfmodel.makespan import (  # noqa: F401
    MakespanSamples,
    empirical_speedup_curve,
    simulate,
    single_delay_makespans,
)
from repro_torch.core.perfmodel.speedup import (  # noqa: F401
    asymptotic_speedup,
    exponential_speedup,
    min_procs_exceeding,
    speedup_table,
    uniform_speedup,
)
