"""E[max of P iid draws] — Eq. (8) of the paper — three ways.

closed   : uniform (a+Pb)/(P+1); exponential H_P/lambda (§3.2, §3.3)
quad     : E[max] = int_0^1 Q(v^(1/P)) dv  (substitute u = F(x), then
           v = u^P; Gauss-Legendre stays well-conditioned even at P=8192)
mc       : Monte Carlo over (trials, P) draws
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.perfmodel.distributions import (
    Deterministic,
    Distribution,
    Exponential,
    Shifted,
    Uniform,
)


def harmonic(P: int) -> float:
    """H_P (exact for small P, Euler-Maclaurin beyond 10^6)."""
    if P <= 1_000_000:
        return float(np.sum(1.0 / np.arange(1, P + 1)))
    g = 0.5772156649015328606
    return math.log(P) + g + 1.0 / (2 * P) - 1.0 / (12 * P * P)


def expected_max_closed(dist: Distribution, P: int) -> Optional[float]:
    """Closed-form E[max of P iid draws], or None when no closed form.

    Known: Uniform (a+Pb)/(P+1); Exponential H_P/lambda; Deterministic c;
    Shifted recurses on its base.
    """
    if isinstance(dist, Uniform):
        return (dist.a + P * dist.b) / (P + 1)
    if isinstance(dist, Exponential):
        return harmonic(P) / dist.lam
    if isinstance(dist, Deterministic):
        return dist.c
    if isinstance(dist, Shifted):
        inner = expected_max_closed(dist.base, P)
        return None if inner is None else dist.loc + inner
    return None


_GL_NODES = 512


def expected_max_quad(dist: Distribution, P: int, nodes: int = _GL_NODES,
                      device="cuda") -> float:
    """E[max] by Gauss-Legendre quadrature of int_0^1 Q(v^(1/P)) dv.

    Needs only ``dist.quantile``, evaluated in float64 on ``device``.
    """
    x, w = np.polynomial.legendre.leggauss(nodes)
    v = 0.5 * (x + 1.0)          # [0, 1]
    w = 0.5 * w
    u = v ** (1.0 / P)           # quantile levels of the max
    q = dist.quantile(torch.as_tensor(u, dtype=torch.float64, device=device))
    return float(np.sum(w * q.cpu().numpy()))


def expected_max_mc(dist: Distribution, P: int, trials: int = 20000,
                    seed: int = 0, device="cuda") -> float:
    """E[max] by Monte Carlo: mean over ``trials`` of max over P draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = dist.sample(gen, (trials, P))
    return float(torch.mean(torch.max(draws, dim=1).values))


def expected_max(dist: Distribution, P: int, method: str = "auto",
                 device="cuda") -> float:
    """E[max of P iid draws] from ``dist`` — Eq. (8) of the paper.

    ``method``: ``"auto"`` (closed form when known, else quadrature),
    ``"closed"`` (raise when unavailable), ``"quad"``, or ``"mc"``; the
    last two evaluate on ``device``.
    """
    if method in ("auto", "closed"):
        c = expected_max_closed(dist, P)
        if c is not None:
            return c
        if method == "closed":
            raise ValueError(f"no closed form for {dist.name}")
    if method in ("auto", "quad"):
        return expected_max_quad(dist, P, device=device)
    if method == "mc":
        return expected_max_mc(dist, P, device=device)
    raise ValueError(method)
