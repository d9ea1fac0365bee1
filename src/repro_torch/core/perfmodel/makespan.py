"""Makespan Monte-Carlo simulator (Sections 2-3).

Synchronized  (classical Krylov):  T  = sum_k max_p T_p^k      (Eq. 6)
Pipelined     (split-phase):       T' = max_p sum_k T_p^k      (Eq. 7)

The (trials, K, P) draws are made on ``device`` (the card by default) from
one seeded ``torch.Generator``, ``batch`` trials at a time.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.perfmodel.distributions import Distribution


class MakespanSamples(NamedTuple):
    """Monte-Carlo makespan samples: synchronized vs pipelined, one entry
    per trial, in the sampled distribution's time unit."""

    t_sync: torch.Tensor    # (trials,)
    t_async: torch.Tensor   # (trials,)

    @property
    def speedup_of_means(self) -> float:
        return float(torch.mean(self.t_sync) / torch.mean(self.t_async))


def simulate(dist: Distribution, P: int, K: int, trials: int = 256,
             seed: int = 0, batch: int = 0, device="cuda") -> MakespanSamples:
    """Draw T_p^k iid from ``dist`` and evaluate both makespans.

    ``batch`` > 0 chunks the trials to bound memory at large K*P.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    if batch <= 0:
        batch = trials
    outs_s, outs_a = [], []
    done = 0
    while done < trials:
        nb = min(batch, trials - done)
        draws = dist.sample(gen, (nb, K, P))
        outs_s.append(torch.sum(torch.max(draws, dim=2).values, dim=1))
        outs_a.append(torch.max(torch.sum(draws, dim=1), dim=1).values)
        done += nb
    return MakespanSamples(t_sync=torch.cat(outs_s),
                           t_async=torch.cat(outs_a))


def single_delay_makespans(W: float, T0: float, K: int, P: int = 2
                           ) -> Dict[str, float]:
    """The Fig. 3/4 scenario: process 0 waits W on step 1, process 1 on
    step 2, T0 elsewhere.  Eq. (3): T = 2W + K T0; Eq. (4): T' = W + K T0."""
    t_sync = 2 * W + K * T0
    t_async = W + K * T0
    alpha = K * T0 / W
    return {"t_sync": t_sync, "t_async": t_async,
            "speedup": t_sync / t_async,
            "alpha": alpha,
            "speedup_formula": (2 + alpha) / (1 + alpha)}  # Eq. (5)


def empirical_speedup_curve(dist: Distribution, P: int, Ks, trials: int = 256,
                            seed: int = 0, device="cuda") -> Dict[int, float]:
    """Speedup vs number of steps K: converges to E[max]/mu as K grows."""
    return {int(K): simulate(dist, P, int(K), trials, seed,
                             device=device).speedup_of_means
            for K in Ks}
