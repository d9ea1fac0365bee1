"""Stochastic performance model for pipelined Krylov methods (paper core).

Usage::

    >>> from repro_torch.core.perfmodel import Exponential, asymptotic_speedup
    >>> asymptotic_speedup(Exponential(1.0), P=4)     # H_4 = 25/12 > 2
    >>> from repro_torch.core.perfmodel import simulate
    >>> simulate(Exponential(1.0), P=8, K=1000).speedup_of_means  # on the card
    >>> s_sync_speedup(Exponential(1.0), P=4, s=4, red_latency=8.0)  # > 2
    >>> modeled_depth_speedup(Exponential(1.0), P=4, l=4, red_latency=2.0)
    >>> eq6_iteration_time(Exponential(1.0), P=4, red_latency=0.5)  # Eq. 6
    >>> folk_bound(2)     # the deterministic overlap-only ceiling (Sec. 2)
    >>> recovery_overhead_bound("kill", 10)   # 11 iterations (resync.py)
"""
from repro_torch.core.perfmodel.comm import (  # noqa: F401
    best_grid,
    halo_elems,
    halo_messages,
    halo_wire_time,
    local_extents,
    surface_to_volume,
)
from repro_torch.core.perfmodel.depth import (  # noqa: F401
    block_expected_max,
    crossover_depth,
    depth_speedup_ceiling,
    depth_speedup_table,
    modeled_depth_speedup,
)
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
from repro_torch.core.perfmodel.folk_theorem import (  # noqa: F401
    deterministic_makespans,
    folk_bound,
    overlap_speedup_bound,
    staggered_delay_trace,
    trace_makespans,
)
from repro_torch.core.perfmodel.makespan import (  # noqa: F401
    MakespanSamples,
    empirical_speedup_curve,
    simulate,
    single_delay_makespans,
)
from repro_torch.core.perfmodel.queueing import (  # noqa: F401
    eq6_iteration_time,
    eq7_iteration_time,
)
from repro_torch.core.perfmodel.resync import (  # noqa: F401
    FAULT_RECOVERY_KINDS,
    abft_detection_iters,
    adaptive_rr_overhead_iters,
    adaptive_rr_replacements,
    detection_iters,
    expected_fault_makespan,
    optimal_checkpoint_period,
    recovery_overhead_bound,
    resync_iter_time,
)
from repro_torch.core.perfmodel.speedup import (  # noqa: F401
    asymptotic_speedup,
    exponential_speedup,
    min_procs_exceeding,
    speedup_table,
    uniform_speedup,
)
from repro_torch.core.perfmodel.sync import (  # noqa: F401
    SOLVER_SYNC_COUNTS,
    s_sync_ceiling,
    s_sync_speedup,
    s_sync_table,
)
