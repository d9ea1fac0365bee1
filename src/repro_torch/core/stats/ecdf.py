"""Empirical CDF utilities (Figs. 5-6)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def as_samples(samples) -> torch.Tensor:
    """A 1-D float64 CPU tensor of ``samples`` (array-like or tensor)."""
    if isinstance(samples, torch.Tensor):
        return samples.detach().to("cpu", torch.float64).reshape(-1)
    return torch.from_numpy(np.asarray(samples, np.float64).reshape(-1))


def ecdf(samples) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted x, F_n(x)) with F_n(x_i) = i/n (right-continuous)."""
    x = torch.sort(as_samples(samples)).values
    n = x.shape[0]
    return x, torch.arange(1, n + 1, dtype=torch.float64) / n


def ecdf_at(samples, x) -> torch.Tensor:
    """The right-continuous ECDF of ``samples`` at the points ``x``."""
    s = torch.sort(as_samples(samples)).values
    return torch.searchsorted(s, as_samples(x), right=True).to(
        torch.float64) / s.shape[0]
