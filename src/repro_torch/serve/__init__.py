"""Solver-as-a-service: the continuous-batching serve layer, and the
latency statistics the LM serving loop shares with it.

Multiplexes many concurrent (operator, b, tol, deadline) solve requests
onto the multi-RHS pipelined CG of ``core/krylov``: a request queue with
earliest-deadline-first admission, a k-slot continuous batcher that
admits new RHS into free columns and retires converged ones mid-flight
(one fused sweep launch an iteration for all k columns on the card),
cached batch steps across requests, open-loop load generation from the
campaign's noise machinery, and chaos faults from ``core/noise/faults``.
The matching latency model (Eq. 6/7 iteration time x an M/G/k wait
term) lives in ``core/perfmodel/queueing.py``; the campaign's serve
stage (``experiments/serve_exec.py``) measures one against the other.
"""
from repro_torch.serve.batcher import (  # noqa: F401
    ContinuousBatcher,
    clear_compile_cache,
    get_compiled,
)
from repro_torch.serve.chaos import ServeChaos  # noqa: F401
from repro_torch.serve.load import (  # noqa: F401
    arrival_times,
    laplacian_mode_rhs,
    synthetic_requests,
)
from repro_torch.serve.metrics import LatencyStats, ServeStats  # noqa: F401
from repro_torch.serve.queue import RequestQueue  # noqa: F401
from repro_torch.serve.request import (  # noqa: F401
    ServeRecord,
    SolveRequest,
    content_key,
    group_key,
    operator_fingerprint,
)
from repro_torch.serve.server import SolverServer  # noqa: F401
