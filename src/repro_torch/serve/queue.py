"""Request queue with earliest-deadline-first admission.

Admission policy: among the ARRIVED requests of one content group
(same operator coefficients/shape/dtype/M/ip — what a batch can share),
pick the earliest absolute deadline (``arrival_s + deadline_s``), ties
broken by arrival order (the ``seq`` counter makes the sort stable and
total).

Starvation bound (what tests/test_torch_serve.py pins): with EDF admission
into k slots where every occupant retires within ``ceil(maxiter / B)``
blocks, a request r with E earlier-deadline compatible peers is admitted
within ``ceil((E + k) / k) * ceil(maxiter / B)`` blocks of its arrival —
each "wave" of k earlier requests can hold the batch for at most one
full solve, and no later-deadline request can overtake r.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.request import SolveRequest, content_key


class RequestQueue:
    """Arrived-but-unadmitted requests, EDF-ordered within content groups."""

    def __init__(self):
        self._items: List[Tuple[float, int, SolveRequest]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._items)

    def push(self, req: SolveRequest) -> None:
        """Enqueue an arrived request."""
        self._items.append((req.arrival_s + req.deadline_s,
                            next(self._seq), req))
        self._items.sort(key=lambda t: (t[0], t[1]))

    def peek_group(self) -> Optional[Tuple]:
        """Content key of the most urgent queued request (None if empty)."""
        if not self._items:
            return None
        return content_key(self._items[0][2])

    def pop_compatible(self, key: Tuple) -> Optional[SolveRequest]:
        """Most urgent queued request matching ``key`` (None if none)."""
        for i, (_, _, req) in enumerate(self._items):
            if content_key(req) == key:
                return self._items.pop(i)[2]
        return None

    def pop_urgent(self) -> Optional[SolveRequest]:
        """Most urgent queued request regardless of group (None if empty)."""
        if not self._items:
            return None
        return self._items.pop(0)[2]

    def peek(self) -> Optional[SolveRequest]:
        """Most urgent queued request WITHOUT removing it (None if empty)."""
        if not self._items:
            return None
        return self._items[0][2]

    def group_sizes(self) -> Dict[Tuple, int]:
        """Queued request count per content group (diagnostics)."""
        out: Dict[Tuple, int] = {}
        for _, _, req in self._items:
            k = content_key(req)
            out[k] = out.get(k, 0) + 1
        return out
