"""Chaos adapter: ``core/noise/faults`` FaultSpecs against the serve loop.

The distributed solvers consume
:class:`~repro_torch.core.noise.faults.FaultSpec` through a per-rank
injector; the serving layer reuses the SAME specs (and the
``"kill:1@10"`` string grammar) but maps them onto its own failure
domain: batch SLOTS instead of ranks, batch BLOCKS instead of solver
iterations:

* ``kill``    — one-shot: poison slot ``shard % k`` with NaNs at block
  ``at_iter`` (a lost accelerator shard taking its column's state with
  it); the server detects the non-finite residual at the next block
  boundary and restarts the victim request from scratch.
* ``stall``   — persistent: every block from ``at_iter`` on sleeps
  ``stall_s`` extra seconds (a straggling host stretching every launch).
* ``corrupt`` — one-shot: add ``magnitude`` to the column's carried
  solution vector — a SILENT corruption the recurrence never sees
  (the column still "converges"), so only the server's true-residual
  exit check can catch it.
"""
from __future__ import annotations

from typing import List, Sequence, Union

from repro_torch.core.noise.faults import FaultEvent, FaultSpec, make_fault


class ServeChaos:
    """Scheduled fault campaign for one serve run."""

    def __init__(self, faults: Sequence[Union[str, FaultSpec]] = ()):
        self.faults: List[FaultSpec] = [
            f if isinstance(f, FaultSpec) else make_fault(f) for f in faults]
        self.events: List[FaultEvent] = []
        self._fired: set = set()

    def pre_step(self, batcher, block_idx: int) -> float:
        """Apply due faults before one batch step; returns extra sleep (s)."""
        extra = 0.0
        for i, f in enumerate(self.faults):
            if f.kind == "stall":
                if block_idx >= f.at_iter:
                    extra += f.stall_s
                    if i not in self._fired:
                        self._fired.add(i)
                        self.events.append(
                            FaultEvent("stall", f.shard, block_idx))
                continue
            if i in self._fired or block_idx < f.at_iter:
                continue
            slot = f.shard % batcher.k
            if batcher.slots[slot] is None:
                continue  # stays armed until the slot holds a victim
            self._fired.add(i)
            self.events.append(FaultEvent(f.kind, slot, block_idx))
            if f.kind == "kill":
                batcher.poison(slot)
            elif f.kind == "corrupt":
                batcher.corrupt(slot, f.magnitude)
        return extra
