"""Split-phase reductions: issue an all-reduce now, wait for it later.

MPI's MPI_Iallreduce/MPI_Wait pair, over ``torch.distributed.all_reduce
(async_op=True)``.  The pipelined solvers move the CONSUMER of a
reduction past independent work: the row issued at the end of iteration i
is waited for in iteration i+1, after that iteration's halo exchange and
before its kernel launch, which needs alpha and beta.

The JAX package proves the overlap from compiled HLO (one all-reduce per
loop body, independent of the halo permutes).  Eager PyTorch has no HLO;
here ``OrderRecorder`` logs, per iteration, the order of the four events
``issue``, ``halo``, ``wait`` and ``launch`` with their host times, and
``split_phase_ok`` checks ``issue(i) < halo(i+1) < wait(i) < launch(i+1)``
with exactly one reduction issued per iteration.  Iteration -1 is the
solve's set-up, whose row the first iteration waits for.  The plain-torch
BSR-chain and 2-D-grid bodies (core/krylov/distributed.py::
sharded_pipecg_bsr_solve, ::sharded_pipecg_solve_2d) log the same four
events, ``launch`` marking the issue of their local sweep's torch ops.

The depth-l body (core/krylov/distributed.py::sharded_pipecg_depth_solve)
logs the same four events once per block of l iterations, with the block
as the iteration number; its reduction is consumed in the block that
issues it, and ``depth_order_ok`` checks ``halo(b) < launch(b) <
issue(b) < wait(b) < halo(b+1)`` with exactly one reduction per block,
the port's stand-in for the JAX package's HLO ``depth_ok``
(launch/hlo_analysis.py).

``DelayedValue`` / ``delayed_update`` / ``pipelined_scan`` are the
reference's one-step-delayed reduction in a scan-shaped loop: the value
consumed at step k is the reduction initiated at step k-1, carried
through the loop state (pipelined clipping, ``optim/clipping.py``, is the
same pattern in optimizer form).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import comm

EVENTS = ("issue", "halo", "wait", "launch")


class OrderRecorder:
    """Appends ``(event, iteration, host seconds)`` as events happen."""

    def __init__(self):
        self.events: List[Tuple[str, int, float]] = []

    def __call__(self, event: str, iteration: int) -> None:
        self.events.append((event, int(iteration), time.perf_counter()))

    def segments(self) -> Dict[str, float]:
        """Mean host seconds per iteration from the event before each event.

        Split-phase log: ``halo`` from the last issue to the end of the
        strip exchange, ``wait`` then to the reduction's result,
        ``launch`` then through the recurrence to the kernel's launch,
        ``issue`` then through the freeze (and any noise) to the next
        issue.  Depth log: ``halo`` from the last block's result through
        its steps to this block's strips, ``launch`` then to the chain
        sweep, ``issue`` then through the deviation row (and any noise)
        to the reduction, ``wait`` to its result.  Events are counted
        from the first ``halo`` of iteration 1 to the last ``issue``
        (iteration 0 waits for the set-up).
        """
        ev = self.events
        out = dict(halo=0.0, wait=0.0, launch=0.0, issue=0.0)
        start = next((k for k, e in enumerate(ev)
                      if e[0] == "halo" and e[1] >= 1), None)
        if start is None:
            return out
        last = max(k for k, e in enumerate(ev) if e[0] == "issue")
        count = dict.fromkeys(out, 0)
        for k in range(start, last + 1):
            out[ev[k][0]] += ev[k][2] - ev[k - 1][2]
            count[ev[k][0]] += 1
        return {k: v / max(count[k], 1) for k, v in out.items()}


class CountingRecorder(OrderRecorder):
    """An :class:`OrderRecorder` that also reads the wire's counters when
    the set-up's reduction is issued (iteration -1), so that what the
    iterations sent can be told from the set-up's exchanges:
    :meth:`loop_counts` gives the blocking all-reduces (``comm.all_reduce``
    calls) and the strips sent by face (``comm.exchange_along.sends``)
    from then on.  The split-phase reductions are the ``issue`` events."""

    def __init__(self):
        super().__init__()
        self._at_setup = None

    def __call__(self, event: str, iteration: int) -> None:
        if event == "issue" and iteration == -1:
            self._at_setup = (comm.all_reduce.calls,
                              dict(comm.exchange_along.sends))
        super().__call__(event, iteration)

    def loop_counts(self) -> Dict[str, object]:
        """``{"issues", "blocking", "sends"}`` since the set-up's issue
        (its own issue excluded); None entries if it never came."""
        if self._at_setup is None:
            return {"issues": None, "blocking": None, "sends": None}
        calls, sends = self._at_setup
        now = comm.exchange_along.sends
        return {
            "issues": sum(e[0] == "issue" and e[1] >= 0
                          for e in self.events),
            "blocking": comm.all_reduce.calls - calls,
            "sends": {face: now[face] - sends.get(face, 0) for face in now
                      if now[face] != sends.get(face, 0)},
        }


def split_phase_ok(events, iterations: int) -> bool:
    """True when the log shows the split-phase order for every iteration.

    ``events`` holds ``(event, iteration, ...)`` in order.  For i in
    [-1, iterations - 1): one ``issue(i)``, then ``halo(i+1)``, then
    ``wait(i)``, then ``launch(i+1)``; and one ``issue`` and one ``wait``
    for the last iteration's row.
    """
    pos = {}
    for at, ev in enumerate(events):
        key = tuple(ev[:2])
        if key in pos or key[0] not in EVENTS:
            return False          # an event twice, or an unknown one
        pos[key] = at
    if len(events) != 4 * iterations + 2:
        return False
    for i in range(-1, iterations - 1):
        keys = [("issue", i), ("halo", i + 1), ("wait", i),
                ("launch", i + 1)]
        if any(k not in pos for k in keys):
            return False
        at = [pos[k] for k in keys]
        if at != sorted(at):
            return False
    last = iterations - 1
    return (("issue", last) in pos and ("wait", last) in pos
            and pos[("issue", last)] < pos[("wait", last)])


def depth_order_ok(events, blocks: int) -> bool:
    """True when the log shows the depth-l order for every block.

    ``events`` holds ``(event, block, ...)`` in order: per block exactly
    one ``halo``, ``launch``, ``issue`` and ``wait``, in that order, and
    the block's ``wait`` before the next block's ``halo``.
    """
    pos = {}
    for at, ev in enumerate(events):
        key = tuple(ev[:2])
        if key in pos or key[0] not in EVENTS:
            return False          # an event twice, or an unknown one
        pos[key] = at
    if len(events) != 4 * blocks:
        return False
    order = []
    for b in range(blocks):
        keys = [("halo", b), ("launch", b), ("issue", b), ("wait", b)]
        if any(k not in pos for k in keys):
            return False
        order += [pos[k] for k in keys]
    return order == sorted(order)


class Pending:
    """A reduction in flight; ``wait()`` returns the summed tensor."""

    def __init__(self, work, buf: torch.Tensor, device: torch.device,
                 iteration: int, record):
        self._work, self._buf, self._device = work, buf, device
        self._iteration, self._record = iteration, record

    def wait(self) -> torch.Tensor:
        if isinstance(self._work, tuple):        # (wire, sum number)
            wire, k = self._work
            wire.result(k, self._buf)
        else:
            self._work.wait()
        if self._record is not None:
            self._record("wait", self._iteration)
        return comm.from_wire(self._buf, self._device)


class SplitPhaseReduce:
    """Issues sum all-reduces over ``group`` that are waited for later."""

    def __init__(self, group=None, record: Optional[OrderRecorder] = None):
        self.group = group
        self.record = record

    def issue(self, t: torch.Tensor, iteration: int) -> Pending:
        """Start summing a copy of ``t``; ``t`` itself is left unchanged.

        On the shared-memory wire a row on the card is copied to pinned
        host memory without blocking, and posted with the event after the
        copy: the next strip exchange's synchronisation (or the wait)
        publishes it, so the row and the strips leave the card in one
        synchronisation."""
        staged = comm.host_staged(t.device, self.group)
        wire = comm.wire_for(self.group)
        if wire is not None and (staged or t.device.type == "cpu") \
                and wire.fits(t):
            if staged:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                buf, ready = comm.to_wire(t, False), None
            work = (wire, wire.post(buf, ready))
        else:
            buf = comm.to_wire(t, staged)
            comm.flush()
            work = dist.all_reduce(buf, group=self.group, async_op=True)
        if self.record is not None:
            self.record("issue", iteration)
        return Pending(work, buf, t.device, iteration, self.record)


class DelayedValue(NamedTuple):
    """Carried state of a one-step-delayed reduction."""

    value: torch.Tensor       # reduction result from the PREVIOUS step
    valid: torch.Tensor       # False on the first step


def delayed_init(like: torch.Tensor) -> DelayedValue:
    return DelayedValue(value=torch.zeros_like(like),
                        valid=torch.zeros((), dtype=torch.bool,
                                          device=like.device))


def delayed_update(prev: DelayedValue, new_reduction: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, DelayedValue]:
    """Returns (value_to_consume, is_valid, next_carry).

    ``new_reduction`` is this step's freshly initiated reduction; the
    returned value is LAST step's: the split-phase contract."""
    nxt = DelayedValue(value=new_reduction,
                       valid=torch.ones((), dtype=torch.bool,
                                        device=new_reduction.device))
    return prev.value, prev.valid, nxt


def pipelined_scan(body: Callable, reducer: Callable, carry_init: Any,
                   xs: torch.Tensor, init_reduction: torch.Tensor):
    """A scan over the leading axis of ``xs`` where
    ``body(carry, x, delayed_reduction)`` consumes the reduction computed by
    ``reducer`` one step earlier (the reference's ``lax.scan``, as a loop).

    body    : (carry, x, (red_prev, valid)) -> (carry, y, red_input)
    reducer : red_input -> tensor reduction (e.g. an all-reduced norm)

    Returns (carry, ys stacked along a new leading axis, last carry of the
    delayed reduction).
    """
    carry = carry_init
    delayed = DelayedValue(value=init_reduction,
                           valid=torch.zeros((), dtype=torch.bool,
                                             device=init_reduction.device))
    ys = []
    for x in xs:
        value, valid, _ = delayed_update(delayed, delayed.value)
        carry, y, red_in = body(carry, x, (value, valid))
        delayed = DelayedValue(value=reducer(red_in),
                               valid=torch.ones((), dtype=torch.bool,
                                                device=init_reduction.device))
        ys.append(y)
    return carry, torch.stack(ys), delayed
