"""Waiting-time distributions (Section 3 of the paper).

Each distribution exposes pdf / cdf / quantile / mean / sample, so the
expected-max machinery (Eq. 8) can use closed forms, quadrature, or Monte
Carlo interchangeably.  Sampling is ``quantile(uniform)``: uniforms on
[1e-12, 1) drawn from an explicit ``torch.Generator`` on the generator's
device, float64 unless asked otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

SQRT2 = math.sqrt(2.0)
_U_MIN = 1e-12  # lower end of the sampled uniforms (keeps quantiles finite)


def uniforms(gen: torch.Generator, shape, dtype=torch.float64) -> torch.Tensor:
    """Uniforms on [1e-12, 1) from ``gen``, on the generator's device."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return _U_MIN + (1.0 - _U_MIN) * u


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Waiting-time distribution interface (arbitrary, consistent unit).

    Subclasses provide ``pdf`` / ``cdf`` / ``quantile`` (elementwise on
    tensors), the scalar ``mean``, and inherit inverse-CDF ``sample``.
    """

    name: ClassVar[str] = "base"

    def pdf(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def cdf(self, x):
        raise NotImplementedError

    def quantile(self, u):
        raise NotImplementedError

    @property
    def mean(self):
        raise NotImplementedError

    def sample(self, gen: torch.Generator, shape, dtype=torch.float64):
        """Draws of ``shape`` on the generator's device."""
        return self.quantile(uniforms(gen, shape, dtype))


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    """Uniform on [a, b] — the paper's §3.2 waiting-time window."""

    a: float = 0.0
    b: float = 1.0
    name: ClassVar[str] = "uniform"

    def pdf(self, x):
        inside = (x >= self.a) & (x <= self.b)
        return torch.where(inside, torch.full_like(x, 1.0 / (self.b - self.a)),
                           torch.zeros_like(x))

    def cdf(self, x):
        return torch.clamp((x - self.a) / (self.b - self.a), 0.0, 1.0)

    def quantile(self, u):
        return self.a + (self.b - self.a) * u

    @property
    def mean(self):
        return 0.5 * (self.a + self.b)


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential with rate ``lam`` (mean 1/lam) — §3.3, the OS-noise
    model the paper's measurements support."""

    lam: float = 1.0
    name: ClassVar[str] = "exponential"

    def pdf(self, x):
        return torch.where(x >= 0, self.lam * torch.exp(-self.lam * x),
                           torch.zeros_like(x))

    def cdf(self, x):
        return torch.where(x >= 0, 1.0 - torch.exp(-self.lam * x),
                           torch.zeros_like(x))

    def quantile(self, u):
        return -torch.log1p(-u) / self.lam

    @property
    def mean(self):
        return 1.0 / self.lam


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    """Log-normal: ln X ~ N(mu, sigma^2) — §3.4 (quadrature only)."""

    mu: float = 0.0
    sigma: float = 1.0
    name: ClassVar[str] = "lognormal"

    def pdf(self, x):
        x = torch.clamp(x, min=1e-300)
        z = (torch.log(x) - self.mu) / self.sigma
        return torch.exp(-0.5 * z * z) / (x * self.sigma
                                          * math.sqrt(2 * math.pi))

    def cdf(self, x):
        x = torch.clamp(x, min=1e-300)
        return 0.5 + 0.5 * torch.special.erf(
            (torch.log(x) - self.mu) / (SQRT2 * self.sigma))

    def quantile(self, u):
        return torch.exp(self.mu + self.sigma * SQRT2
                         * torch.special.erfinv(2.0 * u - 1.0))

    @property
    def mean(self):
        return math.exp(self.mu + 0.5 * self.sigma ** 2)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Shape-k, scale-theta gamma (bridges exponential k=1 and ~normal k>>1)."""

    k: float = 2.0
    theta: float = 1.0
    name: ClassVar[str] = "gamma"

    def pdf(self, x):
        x = torch.clamp(x, min=0.0)
        lg = math.lgamma(self.k)
        return torch.exp((self.k - 1) * torch.log(torch.clamp(x, min=1e-300))
                         - x / self.theta - lg - self.k * math.log(self.theta))

    def cdf(self, x):
        z = torch.clamp(x, min=0.0) / self.theta
        return torch.special.gammainc(torch.full_like(z, self.k), z)

    def quantile(self, u):  # no closed form: bisection
        lo = torch.zeros_like(u)
        hi = torch.full_like(u, self.k * self.theta * 50.0 + 50.0)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            below = self.cdf(mid) < u
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        return 0.5 * (lo + hi)

    @property
    def mean(self):
        return self.k * self.theta


@dataclasses.dataclass(frozen=True)
class Pareto(Distribution):
    """Heavy tail beyond log-normal; alpha > 1 for finite mean."""

    xm: float = 1.0
    alpha: float = 2.5
    name: ClassVar[str] = "pareto"

    def pdf(self, x):
        ok = x >= self.xm
        return torch.where(ok, self.alpha * self.xm ** self.alpha
                           / torch.clamp(x, min=self.xm) ** (self.alpha + 1),
                           torch.zeros_like(x))

    def cdf(self, x):
        ok = x >= self.xm
        return torch.where(ok, 1.0 - (self.xm / torch.clamp(x, min=self.xm))
                           ** self.alpha, torch.zeros_like(x))

    def quantile(self, u):
        return self.xm * (1.0 - u) ** (-1.0 / self.alpha)

    @property
    def mean(self):
        return self.alpha * self.xm / (self.alpha - 1.0)


@dataclasses.dataclass(frozen=True)
class Shifted(Distribution):
    """T = loc + X: deterministic compute time + stochastic waiting time."""

    base: Distribution = dataclasses.field(default_factory=Exponential)
    loc: float = 0.0
    name: ClassVar[str] = "shifted"

    def pdf(self, x):
        return self.base.pdf(x - self.loc)

    def cdf(self, x):
        return self.base.cdf(x - self.loc)

    def quantile(self, u):
        return self.loc + self.base.quantile(u)

    @property
    def mean(self):
        return self.loc + self.base.mean


@dataclasses.dataclass(frozen=True)
class Deterministic(Distribution):
    """Point mass at ``c``: the deterministic (no-noise) limit, in which
    the folk theorem forbids any speedup (§2)."""

    c: float = 1.0
    name: ClassVar[str] = "deterministic"

    def pdf(self, x):
        raise ValueError("point mass has no density")

    def cdf(self, x):
        return (x >= self.c).to(torch.float32)

    def quantile(self, u):
        return torch.full_like(torch.as_tensor(u, dtype=torch.float32),
                               self.c)

    @property
    def mean(self):
        return self.c

    def sample(self, gen: torch.Generator, shape, dtype=torch.float64):
        return torch.full(shape, self.c, dtype=dtype, device=gen.device)
