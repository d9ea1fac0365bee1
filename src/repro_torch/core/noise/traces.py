"""Run-time traces: the Table-1 calibrated generator and recorded traces.

The Piz Daint experiments (PETSc KSP ex23, 8192 cores, 5000 forced Krylov
iterates, n = 12 PGMRES / n = 20 PIPECG repeats) are reproduced in silico
with the model the paper proposes: per-run total time = deterministic base
+ stochastic OS-noise accumulation, the noise exponential.  ``TABLE1``
records the paper's observed statistics; ``generate_runs`` draws samples
whose summary statistics and test verdicts reproduce the paper's.

``EmpiricalDistribution`` lets a recorded trace (run times, or the waits a
NoiseHook injected) flow through the same sampling, E[max] and speedup
machinery as the closed-form families of the paper's Section 3.

Draws go through a ``torch.Generator`` on the caller's device (the card
unless the caller asks for the CPU); they are not the JAX package's
numpy draws, so the two are compared statistically.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import ClassVar, Dict

import numpy as np
import torch

from repro_torch.core.perfmodel.distributions import Distribution, uniforms

# The paper's Table 1 (observed on Piz Daint).
TABLE1: Dict[str, Dict[str, float]] = {
    "GMRES": {"mean": 0.9465, "median": 0.9932, "s": 0.1303, "s2": 0.0170,
              "lambda": 1.0565, "min": 0.6617, "max": 1.0740, "n": 12},
    "PGMRES": {"mean": 0.5902, "median": 0.5856, "s": 0.0962, "s2": 0.0092,
               "lambda": 1.6942, "min": 0.4644, "max": 0.7697, "n": 12},
    "CG": {"mean": 0.9349, "median": 0.8632, "s": 0.2385, "s2": 0.0569,
           "lambda": 1.0696, "min": 0.6051, "max": 1.6060, "n": 20},
    "PIPECG": {"mean": 0.7521, "median": 0.6792, "s": 0.2429,
               "lambda": 1.3295, "s2": 0.0590, "min": 0.5545, "max": 1.6950,
               "n": 20},
}

PIZ_DAINT_P = 8192
EX23_N = 2_097_152
EX23_ITERS = 5000


def _exponential(gen: torch.Generator, scale: float, shape) -> torch.Tensor:
    """Exponential(mean ``scale``) draws on the generator's device."""
    return -torch.log1p(-uniforms(gen, shape)) * scale


@dataclasses.dataclass(frozen=True)
class RunModel:
    """runtime = base + Exp(scale): base = noise-free makespan, Exp = the
    run-level accumulation of OS-noise delays (the paper's finding: run
    times are consistent with an exponential, not a uniform window)."""

    base: float
    scale: float

    def sample(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """``n`` float64 run times on the generator's device."""
        return self.base + _exponential(gen, self.scale, (n,))


def calibrated_model(alg: str) -> RunModel:
    """Method-of-moments calibration against Table 1: base ~ X_min shifted
    by the expected sample minimum of Exp(scale)."""
    row = TABLE1[alg]
    n = int(row["n"])
    # E[X] = base + scale; E[X_min over n] = base + scale/n
    scale = (row["mean"] - row["min"]) / (1.0 - 1.0 / n)
    base = row["mean"] - scale
    return RunModel(base=base, scale=scale)


def generate_runs(alg: str, n: int = 0, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """Sample ``n`` (Table 1's n by default) calibrated run times for
    ``alg``, deterministic in ``seed``: the generator is seeded with
    ``seed + crc32(alg) % 65536``, the stream offset the JAX package uses."""
    row = TABLE1[alg]
    n = n or int(row["n"])
    gen = torch.Generator(device=device).manual_seed(
        seed + zlib.crc32(alg.encode()) % 65536)
    return calibrated_model(alg).sample(n, gen)


@dataclasses.dataclass(frozen=True)
class EmpiricalDistribution(Distribution):
    """Distribution backed by recorded samples (a noise *trace*).

    Quantiles interpolate the empirical quantile function; the CDF is the
    right-continuous ECDF.  ``samples`` must be a sorted 1-D tuple of
    floats (use ``from_samples``); units are whatever the trace was
    recorded in.
    """

    samples: tuple = ()
    trace_name: str = "trace"
    name: ClassVar[str] = "empirical"

    @staticmethod
    def from_samples(x, trace_name: str = "trace") -> "EmpiricalDistribution":
        """Build from any array-like of recorded values (sorts a copy)."""
        xs = np.sort(np.asarray(x, np.float64))
        return EmpiricalDistribution(samples=tuple(float(v) for v in xs),
                                     trace_name=trace_name)

    def _xs(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.samples, dtype=torch.float64,
                            device=like.device)

    def cdf(self, x):
        """Right-continuous ECDF: #(samples <= x) / n."""
        x = torch.as_tensor(x, dtype=torch.float64)
        xs = self._xs(x)
        return torch.searchsorted(xs, x, right=True) / len(self.samples)

    def quantile(self, u):
        """Linear interpolation of the empirical quantile function.

        ``np.interp`` semantics: clamped to the first and last sample
        outside the grid ``(i - 0.5) / n``.
        """
        u = torch.as_tensor(u, dtype=torch.float64)
        xs = self._xs(u)
        n = len(self.samples)
        grid = (torch.arange(1, n + 1, dtype=torch.float64,
                             device=u.device) - 0.5) / n
        if n == 1:
            return torch.full_like(u, float(xs[0]))
        j = torch.clamp(torch.searchsorted(grid, u, right=True), 1, n - 1)
        g0, g1, x0, x1 = grid[j - 1], grid[j], xs[j - 1], xs[j]
        t = torch.clamp((u - g0) / (g1 - g0), 0.0, 1.0)
        return x0 + t * (x1 - x0)

    @property
    def mean(self):
        """Sample mean of the trace."""
        return float(np.mean(self.samples))


def trace_distribution(alg: str, n: int = 256, seed: int = 0,
                       device="cuda") -> EmpiricalDistribution:
    """Recorded-trace noise source: ``n`` run times from the Table-1
    calibrated model for ``alg`` (GMRES / PGMRES / CG / PIPECG), wrapped
    as an ``EmpiricalDistribution`` named ``trace:<ALG>``."""
    runs = generate_runs(alg, n=n, seed=seed, device=device)
    return EmpiricalDistribution.from_samples(runs.cpu().numpy(),
                                              trace_name=f"trace:{alg}")


def makespan_trace_large(P: int, K: int, *, t0: float, noise_scale: float,
                         trials: int, sync: bool, seed: int = 0,
                         chunk_k: int = 64, batch: int = 16,
                         device="cuda") -> torch.Tensor:
    """Exact makespan sampling at Piz Daint scale (P = 8192, K = 5000)
    without materializing (trials, K, P): ``batch`` trials at a time
    stream over K in chunks of ``chunk_k`` steps, so at most
    (batch, chunk_k, P) draws live at once.

    sync=True  -> T  = sum_k max_p (t0 + w);
    sync=False -> T' = max_p sum_k (t0 + w),
    w ~ Exponential(mean ``noise_scale``).  Returns (trials,) float64 on
    ``device``; the same seed gives both makespans the same draws.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    outs = []
    done_t = 0
    while done_t < trials:
        nb = min(batch, trials - done_t)
        acc_sync = torch.zeros((nb,), dtype=torch.float64, device=device)
        acc_proc = torch.zeros((nb, P), dtype=torch.float64, device=device)
        done = 0
        while done < K:
            kb = min(chunk_k, K - done)
            w = _exponential(gen, noise_scale, (nb, kb, P))
            if sync:
                acc_sync += torch.sum(torch.max(w, dim=2).values, dim=1) \
                    + kb * t0
            else:
                acc_proc += torch.sum(w, dim=1) + kb * t0
            done += kb
        outs.append(acc_sync if sync else torch.max(acc_proc, dim=1).values)
        done_t += nb
    return torch.cat(outs)
