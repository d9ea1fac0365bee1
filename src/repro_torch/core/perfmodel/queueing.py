"""Per-iteration means of the paper's Eq. 6/7 under stochastic waits.

The synchronized step waits for the slowest of P draws and then pays the
reduction latency; the pipelined step hides the reduction behind compute
plus its own wait.  ``t_wire`` (halo bytes on the link) is a data
dependence of the local stencil, so it rides the compute side in both.
The M/G/k request-queueing half of the reference module
(``erlang_c``, ``QueueModel``, ``simulate_batch_queue``) belongs to the
serving layer (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

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
