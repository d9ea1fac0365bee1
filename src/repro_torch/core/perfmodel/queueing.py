"""Per-iteration means of the paper's Eq. 6/7 and the M/G/k request queue.

The synchronized step waits for the slowest of P draws and then pays the
reduction latency; the pipelined step hides the reduction behind compute
plus its own wait.  ``t_wire`` (halo bytes on the link) is a data
dependence of the local stencil, so it rides the compute side in both.

A serving layer multiplexes many solve REQUESTS onto a k-slot continuous
batcher (``repro_torch.serve``), so a request's latency adds a queueing
delay to its service time:

    T_request = W_queue + S_service,   S_service ~ iters x t_iter,

with ``t_iter`` the batch step's per-iteration time (Eq. 6 or 7) and
``W_queue`` the wait of an M/G/k queue whose k servers are the batch
slots: the Allen-Cunneen two-moment approximation (Erlang-C delay of the
matched M/M/k scaled by ``(1 + CV^2) / 2``).  Sojourn quantiles convolve
that (atom + exponential tail) wait law with the empirical service
distribution; :func:`simulate_batch_queue` is the batcher's deterministic
discrete-event twin that the serve stage holds them against.  The M/G/k
part is host numpy: it is arithmetic on measured numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.perfmodel.distributions import Distribution
from repro_torch.core.perfmodel.expected_max import expected_max


def eq6_iteration_time(dist: Distribution, P: int, t_compute: float = 0.0,
                       red_latency: float = 0.0, t_wire: float = 0.0,
                       method: str = "auto", device="cuda") -> float:
    """Expected synchronized iteration time (Eq. 6 per-step mean):
    ``t_compute + t_wire + E[max_P W] + red_latency``.  ``method`` and
    ``device`` go to ``expected_max`` (closed forms need no device)."""
    return t_compute + t_wire + float(expected_max(dist, P, method=method,
                                                   device=device)) \
        + red_latency


def eq7_iteration_time(dist: Distribution, t_compute: float = 0.0,
                       red_latency: float = 0.0,
                       t_wire: float = 0.0) -> float:
    """Expected pipelined iteration time (Eq. 7 per-step mean):
    ``max(t_compute + t_wire + E[W], red_latency)``: the overlapped
    reduction matters only when it outlasts compute plus the wait."""
    return max(t_compute + t_wire + float(dist.mean), red_latency)


def quantile_key(q: float) -> str:
    """Canonical name of a quantile: 0.5 -> 'p50', 0.999 -> 'p999'."""
    pct = q * 100.0
    if abs(pct - round(pct)) < 1e-9:
        return f"p{int(round(pct))}"
    return ("p" + f"{pct:g}").replace(".", "")


def erlang_c(k: int, a: float) -> float:
    """Erlang-C delay probability for k servers at offered load ``a``.

    ``a = lambda / mu`` (offered erlangs); requires ``a < k``.  Computed
    with a numerically stable running sum (no factorials).
    """
    if k <= 0:
        raise ValueError("k must be positive")
    if a <= 0.0:
        return 0.0
    if a >= k:
        return 1.0
    # sum_{j<k} a^j/j! and a^k/k! via running terms
    term = 1.0
    s = 1.0
    for j in range(1, k):
        term *= a / j
        s += term
    term_k = term * a / k
    rho = a / k
    c = term_k / (1.0 - rho)
    return c / (s + c)


@dataclasses.dataclass(frozen=True)
class QueueModel:
    """Analytic M/G/k picture of a k-slot continuous batcher.

    lam        — request arrival rate (1/s)
    service    — empirical service-time samples (s), one per request
                 class member (iterations x per-iteration time)
    k          — number of batch slots (servers)
    """

    lam: float
    service: np.ndarray
    k: int

    @property
    def es(self) -> float:
        """Mean service time E[S]."""
        return float(np.mean(self.service))

    @property
    def cv2(self) -> float:
        """Squared coefficient of variation of the service time."""
        m = self.es
        if m <= 0.0:
            return 0.0
        return float(np.var(self.service) / (m * m))

    @property
    def rho(self) -> float:
        """Per-server utilization ``lambda E[S] / k``."""
        return self.lam * self.es / self.k

    def mean_wait(self) -> float:
        """Allen-Cunneen mean wait: Erlang-C x (1 + CV^2)/2 / (k mu - lam)."""
        if self.rho >= 1.0:
            return math.inf
        a = self.lam * self.es
        c = erlang_c(self.k, a)
        mu = 1.0 / self.es
        return c * (1.0 + self.cv2) / 2.0 / (self.k * mu - self.lam)

    def wait_tail(self, t: np.ndarray) -> np.ndarray:
        """P(W > t): delay atom + exponential tail matching the mean wait.

        ``P(W > t) = C exp(-t / w_bar)`` with ``w_bar`` chosen so the
        mixture's mean equals :meth:`mean_wait` — the classical M/M/k
        conditional-wait-is-exponential shape, CV-corrected.
        """
        if self.rho >= 1.0:
            return np.ones_like(t, float)
        a = self.lam * self.es
        c = erlang_c(self.k, a)
        w = self.mean_wait()
        if c <= 0.0 or w <= 0.0:
            return np.zeros_like(t, float)
        scale = w / c  # E[W | W > 0]
        return c * np.exp(-np.asarray(t, float) / scale)

    def sojourn_quantiles(self, qs: Sequence[float] = (0.5, 0.99, 0.999),
                          ) -> Dict[str, float]:
        """Quantiles of T = W + S by numeric convolution.

        ``P(T <= t) = mean_s [ (1 - P(W > t - s)) 1{t >= s} ]`` over the
        empirical service samples; inverted by bisection per quantile.
        Keys are ``p50`` / ``p99`` / ``p999`` style.
        """
        s = np.asarray(self.service, float)

        def cdf(t: float) -> float:
            dt = t - s
            ok = dt >= 0.0
            if not ok.any():
                return 0.0
            vals = np.zeros_like(s)
            vals[ok] = 1.0 - self.wait_tail(dt[ok])
            return float(vals.mean())

        out: Dict[str, float] = {}
        hi0 = float(s.max()) + max(self.mean_wait(), self.es) * 50.0 + 1e-9
        for q in qs:
            lo, hi = 0.0, hi0
            while cdf(hi) < q:
                hi *= 2.0
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                if cdf(mid) < q:
                    lo = mid
                else:
                    hi = mid
            out[quantile_key(q)] = 0.5 * (lo + hi)
        return out


def predicted_sojourn_quantiles(lam: float, service_s: Sequence[float],
                                k_slots: int,
                                qs: Sequence[float] = (0.5, 0.99, 0.999),
                                ) -> Dict[str, float]:
    """Convenience wrapper: quantiles of the analytic M/G/k sojourn law."""
    model = QueueModel(lam=lam, service=np.asarray(service_s, float),
                       k=k_slots)
    return model.sojourn_quantiles(qs)


def simulate_batch_queue(arrivals_s: Sequence[float],
                         service_iters: Sequence[int],
                         t_iter: float, k_slots: int,
                         step_block: int = 8,
                         policy: str = "edf",
                         deadlines_s: Optional[Sequence[float]] = None,
                         ) -> Dict[str, np.ndarray]:
    """Deterministic discrete-event simulation of the continuous batcher.

    The in-silico twin of ``repro_torch.serve``: k RHS slots advance in
    blocks of ``step_block`` iterations, each block costing
    ``step_block * t_iter`` of wall time; a request occupies a slot for
    ``ceil(d / step_block)`` blocks (its converged column stays frozen
    until the block boundary, exactly like the real batcher), retires,
    and frees the slot for the next queued request (earliest deadline
    first, arrival order among ties).  Idle slots cost nothing; an empty
    batch fast-forwards to the next arrival.

    Returns arrays: ``latency`` (sojourn per request, arrival order),
    ``wait`` (admission delay), ``start`` / ``finish`` times, and the
    mean ``occupancy`` of busy slots over busy blocks.
    """
    arr = np.asarray(arrivals_s, float)
    dem = np.asarray(service_iters, int)
    if arr.shape != dem.shape:
        raise ValueError("arrivals and service_iters must align")
    n = arr.size
    ddl = (np.asarray(deadlines_s, float) if deadlines_s is not None
           else np.full(n, np.inf))
    order = np.argsort(arr, kind="stable")
    t_blk = step_block * t_iter

    start = np.zeros(n)
    finish = np.zeros(n)
    # slot state: remaining blocks + request id (-1 = free)
    rem = np.zeros(k_slots, int)
    who = np.full(k_slots, -1)
    queue: list = []  # indices of arrived, unadmitted requests
    next_arr = 0
    now = 0.0
    done = 0
    busy_slots = 0
    busy_blocks = 0
    while done < n:
        # ingest arrivals up to now
        while next_arr < n and arr[order[next_arr]] <= now + 1e-12:
            queue.append(order[next_arr])
            next_arr += 1
        # admit into free slots (EDF, then arrival order — the sort is
        # stable and `queue` is arrival-ordered)
        if queue and policy == "edf":
            queue.sort(key=lambda i: (arr[i] + ddl[i]))
        for s in range(k_slots):
            if who[s] == -1 and queue:
                i = queue.pop(0)
                who[s] = i
                rem[s] = -(-dem[i] // step_block)  # ceil
                start[i] = now
        if (who == -1).all():
            if next_arr >= n:
                break
            now = max(now, arr[order[next_arr]])
            continue
        # advance one block
        active = who != -1
        busy_slots += int(active.sum())
        busy_blocks += 1
        now += t_blk
        rem[active] -= 1
        for s in range(k_slots):
            if who[s] != -1 and rem[s] <= 0:
                i = who[s]
                finish[i] = now
                who[s] = -1
                done += 1
    occupancy = (busy_slots / (busy_blocks * k_slots)
                 if busy_blocks else 0.0)
    return {"latency": finish - arr, "wait": start - arr,
            "start": start, "finish": finish,
            "occupancy": float(occupancy)}
