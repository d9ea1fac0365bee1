"""Fault injection for many-rank solves: shard loss, stragglers, bit rot.

A :class:`~repro_torch.core.noise.injection.NoiseHook` injects benign
noise: every iteration stalls for a sampled wait.  :class:`FaultInjector`
extends it to fire, at a scheduled iteration on a scheduled shard,

* **kill**: the shard stops taking part.  From ``at_iter`` on its tick is
  NaN, which the sharded bodies add to the partial row they all-reduce
  (core/krylov/distributed.py), so every survivor's next reduction is
  NaN within one iteration: a dead rank whose reduction never completes;
* **stall**: the shard becomes a persistent straggler, sleeping
  ``stall_s`` more every iteration from ``at_iter`` on;
* **corrupt**: one finite garbage tick of size ``magnitude`` rides the
  row once, silently derailing the scalar recurrence.

Faults are named as campaign specs name them: ``"kill:1@10"`` kills
logical shard 1 at its 10th executed iteration (:func:`make_fault`).

Shard identity and iteration counts are per LOGICAL shard: a body calls
the injector with its rank in the current group, which :meth:`set_mesh`
maps to the logical id (``alive[rank]``), so a fault keyed to shard 1
stays with it across elastic shrinks, and each shard draws its waits
from its own substream ``(seed, shard)``.  Each rank is its own process
and builds the same injector (schedule and seed); only its own shard is
ever called there, so only its own faults fire.  The controller
(distributed/fault.py) gathers every rank's record at each segment end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.noise.injection import NoiseHook
from repro_torch.core.perfmodel.distributions import Distribution

FAULT_KINDS = ("kill", "stall", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``shard`` is the LOGICAL shard id (stable across elastic shrinks);
    ``at_iter`` counts that shard's executed iterations (injector calls),
    so a segment re-run after a rollback moves it on rather than firing
    the fault again.
    """

    kind: str                 # "kill" | "stall" | "corrupt"
    shard: int
    at_iter: int
    stall_s: float = 0.05     # extra seconds an iteration (kind="stall")
    magnitude: float = 1e3    # garbage payload size (kind="corrupt")

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.shard < 0 or self.at_iter < 0:
            raise ValueError("fault shard and at_iter must be >= 0")


def make_fault(name: str, **overrides) -> FaultSpec:
    """Resolve a fault name ``"<kind>:<shard>@<iter>"``.

    ``"kill:1@10"`` kills shard 1 at its 10th executed iteration;
    ``"stall:0@5"`` and ``"corrupt:2@8"`` likewise.  Keyword overrides
    (``stall_s=``, ``magnitude=``) go to :class:`FaultSpec`.
    """
    try:
        kind, rest = name.split(":", 1)
        shard_s, iter_s = rest.split("@", 1)
        return FaultSpec(kind=kind, shard=int(shard_s), at_iter=int(iter_s),
                         **overrides)
    except (ValueError, TypeError) as e:
        if isinstance(e, ValueError) and "unknown fault kind" in str(e):
            raise
        raise ValueError(
            f"cannot parse fault {name!r}: expected '<kind>:<shard>@<iter>' "
            f"with kind in {FAULT_KINDS}, e.g. 'kill:1@10'") from e


def make_faults(names: Sequence[str], **overrides) -> List[FaultSpec]:
    """Vector form of :func:`make_fault`."""
    return [make_fault(n, **overrides) for n in names]


@dataclasses.dataclass
class FaultEvent:
    """A fault the injector fired (for the recovery timeline)."""

    kind: str
    shard: int
    at_iter: int              # the shard's executed-iteration count then


class FaultInjector(NoiseHook):
    """NoiseHook that also fires scheduled :class:`FaultSpec` s.

    Per call (one per shard per solver iteration) the injector advances
    that logical shard's iteration count, draws the ambient wait from the
    shard's substream, then applies any scheduled fault:

    * ``kill``: marks the shard dead and returns a NaN tick for good (the
      ambient sleep stops: a dead rank does not stall, it vanishes);
    * ``stall``: sleeps ``stall_s`` more and records the combined wait
      (so the straggler shows in ``step_time_matrix``);
    * ``corrupt``: returns ``magnitude`` once as the tick.

    Otherwise the tick is 0.  ``dist=None`` injects no ambient noise.
    ``dead_shards``, ``events``, ``iter_count`` and ``shard_record`` are
    what the elastic controller reads between solve segments.
    """

    def __init__(self, dist: Optional[Distribution] = None,
                 faults: Sequence[FaultSpec] = (), scale: float = 1e-3,
                 seed: int = 0, n_shards: int = 1):
        super().__init__(dist, scale=scale, seed=seed)
        self.faults: List[FaultSpec] = list(faults)
        for f in self.faults:
            if f.shard >= n_shards:
                raise ValueError(
                    f"fault {f} targets shard {f.shard} but the mesh has "
                    f"only {n_shards} logical shards")
        self.n_shards = int(n_shards)
        self.dead_shards: set = set()
        self.events: List[FaultEvent] = []
        self.iter_count: Dict[int, int] = {}
        self.paused = False
        self._alive: Tuple[int, ...] = tuple(range(n_shards))
        self._fired: set = set()

    def set_mesh(self, alive: Sequence[int]):
        """Declare the current group: ``alive[i]`` is rank i's logical id."""
        self._alive = tuple(int(a) for a in alive)

    def pause(self):
        """Make calls inert (no draws, no faults): warm-up runs."""
        self.paused = True

    def resume(self):
        """Re-arm calls after :meth:`pause`."""
        self.paused = False

    def step_time_matrix(self, start_iter: int = 0,
                         base: float = 0.0) -> np.ndarray:
        """(K, P) per-step waits of the ALIVE shards since ``start_iter``.

        ``base`` adds a constant compute time a step; K is the shortest
        alive record.  In one process this sees only the shards called
        there; the elastic controller builds the same matrix from the
        records every rank sends it.
        """
        cols = [self.shard_record.get(s, [])[start_iter:]
                for s in self._alive]
        return step_matrix(cols, base)

    def __call__(self, shard=None) -> np.ndarray:
        """Ambient wait plus scheduled faults for the rank ``shard`` (its
        index in the current group; None is logical shard 0).  Returns the
        float32 tick."""
        if self.paused:
            return np.zeros((), np.float32)
        rank = 0 if shard is None else int(shard)
        logical = self._alive[rank] if rank < len(self._alive) else rank
        k = self.iter_count.get(logical, 0)
        self.iter_count[logical] = k + 1
        if logical in self.dead_shards:
            return np.full((), np.nan, np.float32)
        wait = 0.0 if self.dist is None else self._draw(logical)
        tick = 0.0
        for i, f in enumerate(self.faults):
            if i in self._fired or f.shard != logical or k < f.at_iter:
                continue
            if f.kind == "kill":
                self._fired.add(i)
                self.dead_shards.add(logical)
                self.events.append(FaultEvent("kill", logical, k))
                return np.full((), np.nan, np.float32)
            if f.kind == "stall":
                # persistent: stays armed, but its onset is logged once
                if not any(e.kind == "stall" and e.shard == logical
                           for e in self.events):
                    self.events.append(FaultEvent("stall", logical, k))
                wait += f.stall_s
            if f.kind == "corrupt":
                self._fired.add(i)
                self.events.append(FaultEvent("corrupt", logical, k))
                tick = f.magnitude
        self._record(logical, wait)
        if wait > 0.0:
            time.sleep(wait)
        return np.asarray(tick, np.float32)


def step_matrix(cols: Sequence[Sequence[float]],
                base: float = 0.0) -> np.ndarray:
    """(K, P) matrix of per-shard wait records, K the shortest record."""
    k = min((len(c) for c in cols), default=0)
    if k == 0:
        return np.zeros((0, len(cols)))
    return base + np.asarray([list(c)[:k] for c in cols], np.float64).T
