"""s-sync generalization of the stochastic makespan model (Eqs. 6/7).

The paper's Eq. 6 models ONE synchronization per iteration: every step
pays the max over processes plus a reduction latency R.  Real solvers
expose ``s`` synchronizations per iteration (CG two, classical BiCGStab
four: rho, <r_hat, v>, <t, s>, <t, t>), and each one both serializes a
reduction latency and re-exposes a max over the per-segment waits:

    synchronized:  t_step = t0 + sum_{j<s} E[max_P W_j] + s R
                         = t0 + E[max_P W] + s R        (W_j = W / s)
    pipelined:     t_step = E[ max(t0 + W, R) ]

where the pipelined variant fuses the s reductions into ONE overlapped
collective (what ``pipebicgstab`` does), so only a single R can bind, and
only when it outlasts the local work.  Two limits anchor the family:

* noise-dominated (R -> 0): the ratio collapses to Eq. 8's E[max_P]/mu;
* latency-dominated (R -> inf): the ratio tends to ``s``.  For CG's s = 2
  this is the folk theorem's 2x; for BiCGStab's s = 4 the same argument
  gives a 4x ceiling, beyond the folk bound.  (The deterministic supremum
  over compute/latency ratios is s + 1, at t0 = R; the quoted ceiling is
  the pure-latency limit.)

All times are in the waiting-time distribution's unit; ``red_latency``
expresses R in the same unit.  The Monte-Carlo part draws on the host
with numpy (core/noise/sampling.py), so a seed gives the JAX package's
numbers for the same distribution.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.noise.sampling import sample_np
from repro_torch.core.perfmodel.distributions import Distribution
from repro_torch.core.perfmodel.expected_max import expected_max

# synchronizations per iteration of the classical solver families (the
# pipelined partners fuse them into one)
SOLVER_SYNC_COUNTS: Dict[str, int] = {"cg": 2, "cr": 2, "gmres": 2,
                                      "bicgstab": 4}


def s_sync_ceiling(s: int) -> float:
    """Latency-dominated ceiling of the s-sync family: ``s``.

    The R -> inf limit of :func:`s_sync_speedup`: s serialized reduction
    latencies against one overlapped reduction.  ``s = 2`` recovers the
    folk theorem's 2x; BiCGStab's ``s = 4`` exceeds it.
    """
    return float(s)


def s_sync_speedup(dist: Distribution, P: int, s: int,
                   red_latency: float = 0.0, t0: float = 0.0,
                   trials: int = 20000, seed: int = 0,
                   device="cuda") -> float:
    """Modeled s-sync speedup: synchronized over fused-overlapped.

    sync step = t0 + E[max_P W] + s R; pipe step = E[max(t0 + W_bar, R)]
    with W_bar the mean of s per-segment draws, a Monte-Carlo expectation
    over ``trials`` host draws, deterministic under ``seed``.  ``device``
    is where ``expected_max`` evaluates a quadrature when ``dist`` has no
    closed form.
    """
    e_max = expected_max(dist, P, method="auto", device=device)
    t_sync = t0 + e_max + s * red_latency
    rng = np.random.default_rng(seed)
    w_bar = sample_np(dist, rng, (trials, s)).mean(axis=1)
    t_pipe = float(np.maximum(t0 + w_bar, red_latency).mean())
    return t_sync / t_pipe


def s_sync_table(dist: Distribution, P: int, syncs: Sequence[int],
                 red_latency: float = 0.0, t0: float = 0.0,
                 trials: int = 20000, seed: int = 0,
                 device="cuda") -> Dict[int, float]:
    """``{s: s_sync_speedup(...)}`` over a grid of sync counts."""
    return {int(s): s_sync_speedup(dist, P, int(s), red_latency, t0,
                                   trials=trials, seed=seed, device=device)
            for s in syncs}
