"""The solver server: queue -> continuous batcher -> records.

One :class:`SolverServer` owns a request queue, a set of per-operator
:class:`~repro_torch.serve.batcher.ContinuousBatcher` s (sharing the
module-level cache of built batch steps), and the serve loop:

1. ingest arrived requests (open-loop arrival stamps) into the queue;
2. bind the batcher of the most urgent group (batchers switch groups
   only when idle — a batch drains its group before yielding);
3. admit EDF-ordered compatible requests into free columns;
4. advance the batch one block (chaos faults apply first);
5. retire columns that converged or hit their iteration cap, verify the
   TRUE residual ``||b - A x||`` on the host (the Cools-style exit check
   that catches silently corrupted recurrences), and restart the column
   from scratch when verification or finiteness fails (bounded by
   ``max_restarts``).

Latency bookkeeping is dual: wall-clock seconds (the benchmark story)
and block indices (deterministic: what the property tests pin).  Each
run also records ``run_counts``: its blocks, admissions (restarts
included), batchers built, detections and the kernel launches it made
(``kernels.ops.launch_counts``), which is what the card's checks hold
against the batch step's arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.krylov import abft
from repro_torch.core.krylov.hostops import dia_matvec_np
from repro_torch.kernels import ops
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.chaos import ServeChaos
from repro_torch.serve.metrics import ServeStats, summarize
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import ServeRecord, SolveRequest, content_key


class SolverServer:
    """Continuous-batching solve server over one device.

    The batch step runs on each operator's device; the engine defaults
    to ``fused`` (the sweep kernel on the card, its plain version on the
    CPU).  ``options`` (a
    :class:`~repro_torch.core.krylov.options.SolverOptions`) is the typed
    way to pick the batch-step engine; it cannot be mixed with loose
    ``engine=``.  Per-request knobs (``maxiter`` / ``tol`` / ``M``) live
    on :class:`~repro_torch.serve.request.SolveRequest` (which
    takes its own ``options=``), and solver features the single-device
    batched path cannot express — noise hooks (serve uses ``chaos=``),
    depth-l pipelining, residual replacement, non-default precision
    policies — are rejected loudly instead of silently dropped.
    """

    def __init__(self, *, k_slots: int = 8, engine: Optional[str] = None,
                 step_block: int = 8, chaos: Optional[ServeChaos] = None,
                 max_restarts: int = 3, poll_s: float = 0.002,
                 options=None):
        if options is not None:
            from repro_torch.core.krylov.options import SolverOptions
            if not isinstance(options, SolverOptions):
                raise TypeError("options= must be a SolverOptions; got "
                                f"{type(options).__name__}")
            if engine is not None:
                raise TypeError(
                    "pass the engine either as options= or as loose "
                    "engine=, not both")
            for field, bad, hint in (
                    ("noise", options.noise is not None,
                     "serve injects faults via chaos="),
                    ("depth", options.depth != 1,
                     "the batched step is depth-1"),
                    ("rr/rr_tau", bool(options.rr or options.rr_tau),
                     "serve re-glues via quarantine restarts"),
                    ("precision", not options.precision.is_default,
                     "the single-device batched path runs at the solve "
                     "dtype"),
                    ("maxiter/tol/M",
                     (options.maxiter, options.tol, options.M)
                     != (100, 0.0, None),
                     "these are per-request — pass options= on "
                     "SolveRequest")):
                if bad:
                    raise ValueError(
                        f"SolverServer cannot honor options.{field}: "
                        f"{hint}")
            engine = options.engine
        self.k_slots = int(k_slots)
        self.engine = engine if engine is not None else "fused"
        self.step_block = int(step_block)
        self.chaos = chaos
        self.max_restarts = int(max_restarts)
        self.poll_s = float(poll_s)
        self._pending: List[SolveRequest] = []
        self._next_rid = 0
        self.records: List[ServeRecord] = []
        self.batchers: Dict[Tuple, ContinuousBatcher] = {}
        self.blocks = 0
        self.per_block_active: List[int] = []
        # ABFT provenance: one DetectionReport per mid-flight deviation
        # trip (fast path) with its slow-path confirm outcome
        self.detections: List[abft.DetectionReport] = []
        self.run_counts: Dict = {}
        self._admissions = 0
        self._inits = 0

    # -- submission ---------------------------------------------------------

    def submit(self, req: SolveRequest) -> int:
        """Queue a request for the next :meth:`run`; returns its rid."""
        if req.rid is None or req.rid < 0:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid + 1)
        self._pending.append(req)
        return req.rid

    def submit_all(self, reqs: List[SolveRequest]) -> List[int]:
        """Vector :meth:`submit`."""
        return [self.submit(r) for r in reqs]

    def warmup(self, template: SolveRequest) -> None:
        """Pre-compile every executable on ``template``'s batch path.

        Runs one admit -> step -> take -> release round on the template's
        batcher so every first-call cost (the kernel library's load, the
        sweep's launch plan, the batcher's state and host bands) is paid
        HERE, not inside a measured (or deadline-bearing) serve run.
        """
        cur = self._batcher_for(template)
        probe = dataclasses.replace(template, rid=-1)
        self._admit(cur, 0, probe)
        cur.step()
        cur.take(0)
        cur.bands_host
        cur.release(0)

    # -- serve loop ---------------------------------------------------------

    def _batcher_for(self, req: SolveRequest) -> ContinuousBatcher:
        key = content_key(req)
        if key not in self.batchers:
            self.batchers[key] = ContinuousBatcher(
                req.A, self.k_slots, engine=self.engine, M=req.M,
                ip=req.ip, step_block=self.step_block)
            self._inits += 1
        return self.batchers[key]

    def _admit(self, cur: ContinuousBatcher, slot: int,
               req: SolveRequest) -> None:
        cur.admit(slot, req)
        self._admissions += 1

    def run(self) -> ServeStats:
        """Drain every submitted request; returns the serving summary."""
        blocks0, admissions0, inits0, det0 = (
            self.blocks, self._admissions, self._inits, len(self.detections))
        launches0 = ops.launch_counts()
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        pending = sorted(self._pending, key=lambda r: r.arrival_s)
        self._pending = []
        queue = RequestQueue()
        run_records: List[ServeRecord] = []
        # per-slot bookkeeping of the CURRENT batcher
        slot_meta: Dict[int, Dict] = {}
        cur: Optional[ContinuousBatcher] = None
        cur_key: Optional[Tuple] = None

        arrival_block: Dict[int, int] = {}

        def ingest(now: float) -> None:
            while pending and pending[0].arrival_s <= now:
                req = pending.pop(0)
                arrival_block[req.rid] = self.blocks
                queue.push(req)

        while pending or len(queue) or (cur is not None and cur.active):
            ingest(clock())
            # bind the most urgent group when idle
            if cur is None or cur.active == 0:
                if len(queue) == 0:
                    if not pending:
                        break
                    dt = pending[0].arrival_s - clock()
                    if dt > 0:
                        time.sleep(min(dt, self.poll_s))
                    continue
                head = queue.peek()
                cur = self._batcher_for(head)
                cur_key = content_key(head)
                slot_meta = {}
            # admit EDF-compatible requests into free columns
            for slot in cur.free_slots():
                req = queue.pop_compatible(cur_key)
                if req is None:
                    break
                self._admit(cur, slot, req)
                slot_meta[slot] = {"req": req, "admitted_s": clock(),
                                   "admitted_block": self.blocks,
                                   "restarts": 0}
            if cur.active == 0:
                continue
            # chaos faults fire before the block they disrupt
            if self.chaos is not None:
                extra = self.chaos.pre_step(cur, self.blocks)
                if extra > 0.0:
                    time.sleep(extra)
            done, iters, rr = cur.step()
            self.blocks += 1
            self.per_block_active.append(cur.active)
            now = clock()
            ingest(now)
            for slot, req in enumerate(cur.slots):
                if req is None:
                    continue
                meta = slot_meta[slot]
                healthy = bool(np.isfinite(rr[slot]))
                capped = bool(iters[slot] >= req.maxiter)
                # mid-flight ABFT fast path: the batcher's per-column
                # state deviation delta = 1^T(b - A x - r) trips on a
                # poisoned/corrupted slot long before retire time (the
                # recurrence never sees a corrupted x, so rr alone
                # cannot).  Quarantine restarts ONLY this column —
                # in-flight neighbours are untouched (columns are
                # independent, see batcher.py).
                if not done[slot] and not capped:
                    dev = float(cur.deviation[slot])
                    scale = float(cur.dev_scale[slot])
                    if not np.isfinite(scale):
                        scale = 0.0   # poisoned scale: any finite dev trips
                    # the clean-state deviation accumulates one rounding
                    # term per iteration (the Cools bound is linear in
                    # the iteration count), so the trip threshold must
                    # grow with it or long solves flood the slow path
                    # with unconfirmed trips
                    thr = abft.checksum_threshold(
                        max(scale, 1e-300), req.A.n,
                        cur.dtype) * max(1.0, float(iters[slot]))
                    if not np.isfinite(dev) or abs(dev) > thr:
                        # slow-path confirm: host true residual vs the
                        # recurrence norm (corruption = the two disagree)
                        x = cur.take(slot)
                        b64 = cur.b_host[slot]
                        if np.all(np.isfinite(x)):
                            res_true = float(np.linalg.norm(
                                b64 - dia_matvec_np(req.A.offsets,
                                                    cur.bands_host, x)))
                        else:
                            res_true = math.inf
                        rec_res = (math.sqrt(max(float(rr[slot]), 0.0))
                                   if healthy else math.inf)
                        confirmed = bool(
                            not np.isfinite(res_true)
                            or res_true > 10.0 * (rec_res + req.tol
                                                  * float(np.linalg.norm(
                                                      b64))))
                        self.detections.append(abft.DetectionReport(
                            solver="pipecg", detector="state_deviation",
                            tripped=True, trip_iter=int(iters[slot]),
                            value=(dev if np.isfinite(dev)
                                   else math.inf),
                            threshold=float(thr), action="quarantine",
                            confirmed=confirmed))
                        if confirmed:
                            if meta["restarts"] < self.max_restarts:
                                cur.release(slot)
                                self._admit(cur, slot, req)
                                meta["restarts"] += 1
                                continue
                            run_records.append(ServeRecord(
                                rid=req.rid, x=None, iters=int(iters[slot]),
                                res_norm=res_true, converged=False,
                                arrival_s=req.arrival_s,
                                admitted_s=meta["admitted_s"],
                                finished_s=now,
                                deadline_s=req.deadline_s,
                                restarts=meta["restarts"],
                                arrival_block=arrival_block.get(req.rid, 0),
                                admitted_block=meta["admitted_block"],
                                finished_block=self.blocks))
                            cur.release(slot)
                            slot_meta.pop(slot, None)
                            continue
                if healthy and not (done[slot] or capped):
                    continue
                x = cur.take(slot) if healthy else None
                ok, res_true = (self._verify(req, x, cur.b_host[slot],
                                             cur.bands_host) if healthy
                                else (False, math.inf))
                if not ok and meta["restarts"] < self.max_restarts \
                        and not (healthy and capped):
                    # restart the column from scratch (kill/corrupt path)
                    cur.release(slot)
                    self._admit(cur, slot, req)
                    meta["restarts"] += 1
                    continue
                rec = ServeRecord(
                    rid=req.rid, x=x, iters=int(iters[slot]),
                    res_norm=res_true,
                    converged=bool(ok),
                    arrival_s=req.arrival_s,
                    admitted_s=meta["admitted_s"], finished_s=now,
                    deadline_s=req.deadline_s,
                    restarts=meta["restarts"],
                    arrival_block=arrival_block.get(req.rid, 0),
                    admitted_block=meta["admitted_block"],
                    finished_block=self.blocks)
                run_records.append(rec)
                cur.release(slot)
                slot_meta.pop(slot, None)
        wall = clock()
        drained = (not pending and len(queue) == 0
                   and all(b.active == 0 for b in self.batchers.values()))
        self.records.extend(run_records)
        after = ops.launch_counts()
        self.run_counts = dict(
            blocks=self.blocks - blocks0,
            admissions=self._admissions - admissions0,
            batcher_inits=self._inits - inits0,
            restarts=sum(r.restarts for r in run_records),
            detections=len(self.detections) - det0,
            launches={k: after[k] - launches0[k] for k in after})
        return summarize(run_records, self.k_slots, self.per_block_active,
                         wall, drained)

    @staticmethod
    def _verify(req: SolveRequest, x: np.ndarray, b64: np.ndarray,
                bands: np.ndarray) -> Tuple[bool, float]:
        """Host-side true-residual exit check: ||b - A x|| <= tol ||b||.

        Pure numpy (no device dispatch on the retire path): the serve
        loop's rendering of the Cools attainable-accuracy exit test: a
        silently corrupted recurrence (chaos ``corrupt``) converges on
        its OWN residual while the true one stalls, so only this check
        catches it.  ``b64`` / ``bands`` are the host copies of b and of
        the operator's bands that the batcher holds.
        """
        y = dia_matvec_np(req.A.offsets, bands,
                          np.asarray(x, np.float64))
        res = float(np.linalg.norm(b64 - y))
        bn = float(np.linalg.norm(b64))
        return bool(np.isfinite(res) and res <= req.tol * bn * 1.01), res
