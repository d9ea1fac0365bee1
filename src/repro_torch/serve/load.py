"""Open-loop load generation for the serving layer.

Arrival processes reuse the campaign's noise machinery
(``experiments/noise_sources.make_distribution`` + host-numpy sampling):
``"poisson"`` draws exponential inter-arrivals, any other name is
resolved as a waiting-time distribution (including the recorded
``"trace:<ALG>"`` empiricals) and its draws are rescaled to the target
mean inter-arrival ``1 / rate``.  Open loop: arrival times are fixed up
front, independent of how fast the server drains (the p99-under-load
regime the queueing model predicts).

Every host draw (arrival gaps, mode indices and coefficients, dense
right-hand sides) is the JAX package's numpy ``Generator`` call in the
same order, so the same seed gives the same sequence; the sine modes of
:func:`laplacian_mode_rhs` are summed on the operator's device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.noise.sampling import sample_np
from repro_torch.experiments.noise_sources import make_distribution
from repro_torch.serve.request import SolveRequest, dtype_name


def arrival_times(name: str, n: int, rate: float, seed: int = 0,
                  device="cuda") -> np.ndarray:
    """``n`` open-loop arrival times (s) at mean rate ``rate`` (1/s).

    ``name``: ``"poisson"`` (exponential inter-arrivals) or any
    ``make_distribution`` name (``uniform`` / ``lognormal`` /
    ``trace:<ALG>`` ...), mean-normalized so the long-run rate is
    ``rate`` regardless of the family's native scale.  ``device`` is
    where a trace's recorded runs are drawn.
    """
    if rate <= 0.0:
        raise ValueError("rate must be positive")
    dist_name = "exponential" if name == "poisson" else name
    dist = make_distribution(dist_name, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    gaps = sample_np(dist, rng, (n,)).astype(float)
    mean = float(dist.mean)
    if mean <= 0.0:
        raise ValueError(f"arrival distribution {name!r} has zero mean")
    gaps = gaps / mean / rate
    return np.cumsum(gaps)


def laplacian_mode_rhs(n: int, m: int, rng: np.random.Generator,
                       device="cuda") -> torch.Tensor:
    """Unit-norm float64 RHS on ``device`` spanning ``m`` random
    1D-Dirichlet-Laplacian modes.

    CG terminates once its residual polynomial annihilates every excited
    eigencomponent, so a RHS built from ``m`` of the Laplacian's sine
    modes converges in about ``m`` iterations: the knob that gives a
    served workload a CONTROLLED service-demand distribution instead of
    the degenerate every-request-takes-n-iterations one.  The modes are
    added one at a time in the order drawn (no (m, n) temporary).
    """
    js = rng.choice(n, size=int(m), replace=False) + 1
    coefs = [rng.standard_normal() for _ in js]
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    b = torch.zeros(n, dtype=torch.float64, device=device)
    for j, c in zip(js, coefs):
        b += float(c) * torch.sin(math.pi * int(j) * i / (n + 1))
    return b / torch.linalg.vector_norm(b)


def synthetic_requests(A: DiaMatrix, n_requests: int, *,
                       tol: float = 1e-8, maxiter: int = 500,
                       deadline_s: float = math.inf,
                       arrival: Optional[Sequence[float]] = None,
                       modes: Optional[Tuple[int, int]] = None,
                       M: Optional[str] = None, ip: str = "id",
                       seed: int = 0) -> List[SolveRequest]:
    """Randomized unit-norm RHS requests against one operator.

    ``modes=(lo, hi)`` draws each RHS from :func:`laplacian_mode_rhs`
    with a uniform mode count in ``[lo, hi]`` (service demand ~ mode
    count), a tensor on the operator's device; the default is a dense
    standard-normal host RHS (demand ~ n).
    """
    rng = np.random.default_rng(seed)
    arr = (np.zeros(n_requests) if arrival is None
           else np.asarray(arrival, float))
    if arr.shape[0] != n_requests:
        raise ValueError("arrival vector must have one entry per request")
    reqs = []
    for i in range(n_requests):
        if modes is not None:
            m = int(rng.integers(modes[0], modes[1] + 1))
            b = laplacian_mode_rhs(A.n, m, rng, device=A.device).to(A.dtype)
        else:
            b = rng.standard_normal(A.n).astype(dtype_name(A.bands))
            b /= np.linalg.norm(b)
        reqs.append(SolveRequest(rid=i, A=A, b=b, tol=tol,
                                 deadline_s=deadline_s, maxiter=maxiter,
                                 arrival_s=float(arr[i]), M=M, ip=ip))
    return reqs
