"""Depth-l extension of the stochastic makespan model (Eqs. 6/7).

The paper's two makespans are the ends of a family indexed by the
pipeline depth ``l``, the number of iterations between initiating a global
reduction and consuming its result:

* ``l -> 0`` (classical, synchronized): T = sum_k [max_p T_p^k + R]:
  every step pays the max over processes AND the reduction latency R
  (Eq. 6 with an explicit reduction term).
* finite ``l`` (depth-l pipelined): the lag-l synchronization process
  ``T_p(k) = max(T_p(k-1), S(k-l) + R) + T_p^k`` with
  ``S(j) = max_p T_p(j)``: a process may run at most l steps ahead of the
  reduction pipeline before blocking.
* ``l -> inf``: the gate never binds and T' = max_p sum_k T_p^k (Eq. 7),
  whose K -> inf speedup is E[max_P] / mu (Eq. 8).

This module is the modeled counterpart of the measured lag-l makespan:
the block-resynchronization bound

    t_pipe(l) = (E[max_p sum_{k<l} T_p^k] + R) / l        per iteration,

i.e. processes fully resynchronize every l steps, a LOWER bound on the
speedup of the lag-l process, converging to the same Eq. 8 asymptote as l
grows, and the crossover depth: the smallest swept l whose speedup
reaches a fraction of that asymptote.  All times are in the waiting-time
distribution's unit; ``red_latency`` expresses R in the same unit.  The
Monte-Carlo part draws on the host with numpy (core/noise/sampling.py),
so a seed gives the JAX package's numbers for the same distribution.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.noise.sampling import sample_np
from repro_torch.core.perfmodel.distributions import Distribution
from repro_torch.core.perfmodel.expected_max import expected_max


def block_expected_max(dist: Distribution, P: int, l: int,
                       trials: int = 4000, seed: int = 0,
                       device="cuda") -> float:
    """Monte-Carlo E[max_p of l-fold iid sums] (the block-resync max).

    At l = 1 this is ``expected_max(dist, P)`` (evaluated on ``device``
    when it needs a quadrature); as l grows the block average
    max_p(sum_l)/l contracts toward the mean mu (LLN), the averaging that
    depth-l pipelining buys.
    """
    if l == 1:
        return expected_max(dist, P, method="auto", device=device)
    rng = np.random.default_rng(seed)
    s = sample_np(dist, rng, (trials, l, P)).sum(axis=1)
    return float(s.max(axis=1).mean())


def modeled_depth_speedup(dist: Distribution, P: int, l: int,
                          red_latency: float = 0.0, t0: float = 0.0,
                          trials: int = 4000, seed: int = 0,
                          device="cuda") -> float:
    """Modeled depth-l speedup: synchronized over block-resync pipelined.

    sync step  = t0 + E[max_P W] + R          (Eq. 6 + reduction term)
    pipe step  = (l*t0 + E[max_p sum_l W] + R) / l   (block-resync bound)

    Monotone in l, approaching (t0 + E[max] + R) / (t0 + mu) as l -> inf;
    a lower bound on the measured lag-l speedup.
    """
    e_max1 = expected_max(dist, P, method="auto", device=device)
    t_sync = t0 + e_max1 + red_latency
    e_block = block_expected_max(dist, P, l, trials=trials, seed=seed,
                                 device=device)
    t_pipe = (l * t0 + e_block + red_latency) / l
    return t_sync / t_pipe


def depth_speedup_ceiling(dist: Distribution, P: int,
                          red_latency: float = 0.0, t0: float = 0.0,
                          device="cuda") -> float:
    """The l -> inf asymptote of the depth family (Eq. 8 with R, t0)."""
    e_max1 = expected_max(dist, P, method="auto", device=device)
    return (t0 + e_max1 + red_latency) / (t0 + float(dist.mean))


def crossover_depth(speedups: Dict[int, float], ceiling: float,
                    frac: float = 0.9) -> int:
    """Smallest swept depth whose speedup reaches ``frac * ceiling``.

    ``speedups`` maps depth l to (measured or modeled) speedup; returns -1
    when no swept depth reaches the threshold: the regime where the
    reduction latency still dominates and deeper pipelines would keep
    paying off.
    """
    for l in sorted(speedups):
        if speedups[l] >= frac * ceiling:
            return int(l)
    return -1


def depth_speedup_table(dist: Distribution, P: int, depths: Sequence[int],
                        red_latency: float = 0.0, t0: float = 0.0,
                        trials: int = 4000, seed: int = 0,
                        device="cuda") -> Dict[int, float]:
    """``{l: modeled_depth_speedup(...)}`` over a grid of depths."""
    return {int(l): modeled_depth_speedup(dist, P, int(l), red_latency, t0,
                                          trials=trials, seed=seed,
                                          device=device)
            for l in depths}
