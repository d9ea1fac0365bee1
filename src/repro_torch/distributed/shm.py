"""A shared-memory wire for the ranks of one host.

Gloo carries every message between ranks over TCP, also between the
processes of one host.  Where those sockets are slow, a solve pays it
every iteration: on the H100 host of PERF.md §5 a blocking all-reduce of
one double over 4 ranks of one card, its copies off and onto the card
included, took 1.47 ms through gloo and 0.70 ms through shared memory
(``torch_allreduce_latency.py --backend shm``), and a 4-rank PIPECG
iteration on ex23 went from 9.46 to 2.30 ms (chip_smoke.py ``[ranks]``).
So the
ranks that :mod:`distributed.ranks` spawns for a gloo group also map one
file that the parent made, and :mod:`distributed.comm` routes through it
the hot traffic of the whole group: the blocking and split-phase sums
and the point-to-point strips.  Gloo keeps the set-up collectives,
every subgroup, and any message larger than a slot.

Layout (``world`` = P ranks): a header of int64 counters, then the sum
slots ``(SUM_SLOTS, P, SLOT)`` and the mailboxes ``(P, P, MAIL_SLOTS,
SLOT)``, bytes.  Protocol, all counters written by one rank only:

* sums: this rank's k-th sum goes to slot ``k % SUM_SLOTS``, once every
  rank has read the sum that used that slot before; then
  ``written[rank] = k + 1``.  A reader waits for ``min(written) > k``,
  adds the P contributions in rank order (so every rank gets the same
  bits), then sets ``read[slot, rank] = k + 1``.
* strips: message m from s to d goes to mailbox ``(s, d, m %
  MAIL_SLOTS)`` once d has consumed message ``m - MAIL_SLOTS``; then
  ``sent[s, d] = m + 1``; d copies it out and sets ``taken[s, d] = m +
  1``.  Each message carries its byte count, checked by the receiver.

Every rank calls the sums in one order, as for any collective, and the
messages of one pair arrive in the order they were sent.  The data is
written before the counter that publishes it, and read after the counter
that says it is there: x86 keeps stores, and loads, in program order, so
the wire is used only on x86 hosts.  A wait spins (yielding the core)
for 2 ms, then polls every 100 µs, and raises after ``TIMEOUT_S``.

A contribution to a sum may be *posted* before its bytes are on the
host: :meth:`Wire.post` takes a pinned buffer that an asynchronous copy
from the card is filling and the CUDA event recorded after it, and
publishes it at :meth:`Wire.flush`, which every other wire call runs
first.  A solve thus copies its reduction row out in the same stream
synchronisation as the next halo strips (core/krylov/distributed.py).
"""
from __future__ import annotations

import mmap
import os
import platform
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

#: bytes of one slot: one rank's contribution to a sum, or one message
SLOT = 64 << 10
#: ring depth of the sum slots (sums in flight at once, plus one)
SUM_SLOTS = 8
#: ring depth of each mailbox
MAIL_SLOTS = 4
#: seconds a rank waits on a peer before the wire raises
TIMEOUT_S = 300.0
#: seconds of spinning before a wait starts to sleep between polls
_SPIN_S = 2e-3

_WIRE: Optional["Wire"] = None


def usable() -> bool:
    """True where the wire's ordering argument holds (x86)."""
    return platform.machine().lower() in ("x86_64", "amd64", "i686",
                                          "i386")


def _layout(world: int) -> Tuple[int, int, int]:
    """Byte offsets of the sum slots and the mailboxes, and the size."""
    counters = world + SUM_SLOTS * world + 2 * world * world \
        + SUM_SLOTS * world + MAIL_SLOTS * world * world
    sums = 8 * counters
    sums = -(-sums // 4096) * 4096
    mail = sums + SUM_SLOTS * world * SLOT
    return sums, mail, mail + world * world * MAIL_SLOTS * SLOT


def create(path: str, world: int) -> None:
    """Make the zeroed (sparse) file of a ``world``-rank wire."""
    with open(path, "wb") as f:
        f.truncate(_layout(world)[2])


def attach(path: str, rank: int, world: int) -> "Wire":
    """Map ``path`` as this process's wire (see :func:`current`)."""
    global _WIRE
    _WIRE = Wire(path, rank, world)
    return _WIRE


def detach() -> None:
    """Unmap this process's wire."""
    global _WIRE
    if _WIRE is not None:
        _WIRE.close()
    _WIRE = None


def current() -> Optional["Wire"]:
    """This process's wire, or None."""
    return _WIRE


def _bytes(t: torch.Tensor) -> np.ndarray:
    """``t``'s bytes as a numpy view (``t`` contiguous, on the host)."""
    return t.reshape(-1).view(torch.uint8).numpy()


class Wire:
    """One rank's view of the shared file (see the module docstring)."""

    def __init__(self, path: str, rank: int, world: int):
        self.rank, self.world = rank, world
        sums, mail, size = _layout(world)
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        c = np.frombuffer(self._mm, dtype=np.int64, count=sums // 8)
        P, at = world, 0

        def take(*shape):
            nonlocal at
            n = int(np.prod(shape))
            out = c[at:at + n].reshape(shape)
            at += n
            return out

        self._written = take(P)
        self._read = take(SUM_SLOTS, P)
        self._sent = take(P, P)
        self._taken = take(P, P)
        self._sum_len = take(SUM_SLOTS, P)
        self._mail_len = take(P, P, MAIL_SLOTS)
        raw = np.frombuffer(self._mm, dtype=np.uint8)
        self._sums = raw[sums:mail].reshape(SUM_SLOTS, P, SLOT)
        self._mail = raw[mail:size].reshape(P, P, MAIL_SLOTS, SLOT)
        self._calls = 0                        # sums this rank has posted
        self._out = [0] * P                    # messages sent to each rank
        self._in = [0] * P                     # messages taken from each
        self._posted: List[Tuple[int, torch.Tensor, object]] = []

    def close(self) -> None:
        self._sums = self._mail = None
        self._written = self._read = self._sent = self._taken = None
        self._sum_len = self._mail_len = None
        try:
            self._mm.close()
        except BufferError:     # a view still held: unmapped when it goes
            pass

    def _until(self, ready, what: str) -> None:
        if ready():
            return
        t0 = time.perf_counter()
        while not ready():
            waited = time.perf_counter() - t0
            if waited > TIMEOUT_S:
                raise RuntimeError(f"shared-memory wire: rank {self.rank} "
                                   f"waited {TIMEOUT_S:.0f} s for {what}")
            if waited < _SPIN_S:
                os.sched_yield()
            else:
                time.sleep(1e-4)

    # -- sums --------------------------------------------------------------
    @staticmethod
    def fits(t: torch.Tensor) -> bool:
        """True when ``t`` fits one slot."""
        return t.numel() * t.element_size() <= SLOT

    def post(self, host: torch.Tensor, ready=None) -> int:
        """Reserve this rank's next sum for ``host`` (contiguous, on the
        host) and return its number; ``ready``, a CUDA event, marks the
        copy that fills ``host``: the contribution is published at the
        next :meth:`flush` (at once without ``ready``)."""
        self.flush()
        k = self._calls
        self._calls += 1
        self._posted.append((k, host, ready))
        if ready is None:
            self.flush()
        return k

    def flush(self) -> None:
        """Publish every posted contribution, in order, once its copy to
        the host is done."""
        while self._posted:
            k, host, ready = self._posted.pop(0)
            if ready is not None:
                ready.synchronize()
            slot, me = k % SUM_SLOTS, self.rank
            reuse = k - SUM_SLOTS + 1
            self._until(lambda: self._read[slot].min() >= reuse,
                        f"sum {k - SUM_SLOTS} to be read")
            data = _bytes(host)
            self._sums[slot, me, :data.size] = data
            self._sum_len[slot, me] = data.size
            self._written[me] = k + 1

    def result(self, k: int, out: torch.Tensor, op: str = "sum"
               ) -> torch.Tensor:
        """Sum k over the group (``op="max"``: its maximum), written into
        ``out`` (this rank's contribution's shape, dtype and device: the
        host) and returned."""
        self.flush()
        self._until(lambda: self._written.min() > k, f"sum {k}")
        slot = k % SUM_SLOTS
        nbytes = out.numel() * out.element_size()
        lens = self._sum_len[slot]
        if (lens != nbytes).any():
            raise RuntimeError(f"shared-memory wire: sum {k} has "
                               f"contributions of {lens.tolist()} bytes, "
                               f"this rank expects {nbytes}")
        parts = [torch.from_numpy(self._sums[slot, j, :nbytes])
                 .view(out.dtype).view(out.shape)
                 for j in range(self.world)]
        out.copy_(parts[0])
        for part in parts[1:]:
            if op == "sum":
                out.add_(part)
            else:
                torch.maximum(out, part, out=out)
        self._read[slot, self.rank] = k + 1
        return out

    # -- strips ------------------------------------------------------------
    def send(self, dst: int, host: torch.Tensor) -> None:
        """Post ``host`` (contiguous, on the host, at most a slot) to
        ``dst``; returns once it is in ``dst``'s mailbox."""
        self.flush()
        me, m = self.rank, self._out[dst]
        self._out[dst] += 1
        box = m % MAIL_SLOTS
        self._until(lambda: self._taken[me, dst] >= m - MAIL_SLOTS + 1,
                    f"rank {dst} to take message {m - MAIL_SLOTS}")
        data = _bytes(host)
        self._mail[me, dst, box, :data.size] = data
        self._mail_len[me, dst, box] = data.size
        self._sent[me, dst] = m + 1

    def recv(self, src: int, out: torch.Tensor) -> None:
        """Fill ``out`` (contiguous, on the host) with the next message
        from ``src``."""
        self.flush()
        me, m = self.rank, self._in[src]
        self._in[src] += 1
        box = m % MAIL_SLOTS
        self._until(lambda: self._sent[src, me] > m,
                    f"message {m} from rank {src}")
        nbytes = out.numel() * out.element_size()
        if self._mail_len[src, me, box] != nbytes:
            raise RuntimeError(
                f"shared-memory wire: message {m} from rank {src} has "
                f"{int(self._mail_len[src, me, box])} bytes, the receive "
                f"buffer {nbytes}")
        _bytes(out)[:] = self._mail[src, me, box, :nbytes]
        self._taken[src, me] = m + 1
