"""A wire between the gloo ranks of one card: buffers shared by CUDA IPC.

When several ranks share one card their group is gloo (NCCL refuses two
ranks on one device), and gloo moves every message through host copies
and TCP sockets.  For a sharded model's gathers and gradient sums that
is the whole cost of a step: on an H100 80GB HBM3 host (PERF.md §6),
qwen3-1.7b's 10.3 GB gathered and 8.1 GB summed a rank a step took
56.3 s, ~330 MB/s a rank.  The ranks' tensors are all on one card, so
this wire keeps them there: every rank of a group exports a device
buffer to the others (``torch.multiprocessing``'s CUDA IPC handles,
exchanged once per buffer through gloo), writes its contribution into
its own buffer, and reads the others' buffers with device copies.

Protocol, per collective on a group: write this rank's tensor into its
buffer ``k % 2`` (k counts the group's collectives), synchronise the
stream, a barrier of the group (through the shared-memory wire of
:mod:`distributed.shm` where it carries the group, else gloo's), then
read every rank's buffer
``k % 2`` in group-rank order (a gather concatenates, a sum adds in that
order, so every rank gets the same bits).  Two buffers a rank: the
reads of collective k are enqueued before this rank's next barrier
(its stream is synchronised first), so a buffer is rewritten only once
every rank has read it.  A buffer grows to the message (for every rank
of the group at once: collectives have one size on every rank) after a
barrier (a message crosses in pieces of ``CHUNK_BYTES``, so a buffer
stays small); :func:`release` drops them between phases of a program.

:mod:`distributed.ranks` attaches the wire in every gloo rank when the
ranks share the machine's only card; :mod:`distributed.comm` takes it for
the mesh collectives of CUDA tensors on such a group.  The protocol runs
on host tensors too (shared through the "file_system" strategy), which
is how tests/test_torch_card_wire.py holds it to gloo on the CPU.
"""
from __future__ import annotations

import pickle
from multiprocessing.reduction import ForkingPickler
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401  (its reductions on the pickler)

from repro_torch.distributed import shm

#: buffers are whole multiples of this many bytes
MIN_BYTES = 1 << 20
#: a message goes through the buffers in pieces of at most this size, so
#: a rank's buffers stay small beside a 1.2 GB gradient (qwen3's head)
CHUNK_BYTES = 64 << 20


class _GroupBuffers:
    """This rank's two buffers for one group and its peers' views."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.calls = 0
        self.cap = 0
        self.mine: List[torch.Tensor] = []
        self.peers: List[List[torch.Tensor]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def ensure(self, nbytes: int) -> None:
        if nbytes <= self.cap:
            return
        if self.cap:
            self._sync()
            dist.barrier(group=self.group)    # nobody reads the old ones
        cap = max(MIN_BYTES, -(-nbytes // MIN_BYTES) * MIN_BYTES)
        self.peers = []
        # normal tensors even when a prefill's inference mode is on: they
        # are written again outside it
        with torch.inference_mode(False):
            self.mine = [torch.empty(cap, dtype=torch.uint8,
                                     device=self.device) for _ in range(2)]
            # torch.multiprocessing's pickler sends a CUDA tensor as its
            # IPC handle (a host tensor by its shared-memory file)
            handles: List[object] = [None] * self.size
            dist.all_gather_object(handles, bytes(ForkingPickler.dumps(
                self.mine)), group=self.group)
            self.peers = [self.mine if j == self.rank else
                          pickle.loads(handles[j])
                          for j in range(self.size)]
        self.cap = cap

    def exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (contiguous, one shape on all ranks) as
        views of their buffers, in group-rank order; valid until this
        rank's next collective on the group."""
        nbytes = t.numel() * t.element_size()
        self.ensure(nbytes)
        k = self.calls % 2
        self.calls += 1
        self.mine[k][:nbytes].copy_(t.reshape(-1).view(torch.uint8))
        self._sync()
        self._barrier()
        return [p[k][:nbytes].view(t.dtype).view(t.shape)
                for p in self.peers]

    def _barrier(self) -> None:
        """Every rank of the group has written its buffer: a sum of one
        value through the shared-memory wire where it carries the group
        (the whole group of spawned ranks: tens of microseconds where a
        gloo barrier over sockets takes about a millisecond), else a
        gloo barrier."""
        wire = shm.current()
        if wire is not None and (self.group is None
                                 or self.group is dist.group.WORLD):
            one = torch.zeros(1)
            wire.result(wire.post(one), one)
        else:
            dist.barrier(group=self.group)


class CardWire:
    """The wire of one rank: its buffers by group."""

    def __init__(self, device: torch.device):
        self.device = device
        self._groups: Dict[object, _GroupBuffers] = {}

    def _buffers(self, group) -> _GroupBuffers:
        key = dist.group.WORLD if group is None else group
        if key not in self._groups:
            self._groups[key] = _GroupBuffers(group, self.device)
        return self._groups[key]

    def _chunks(self, t: torch.Tensor):
        """``t`` flattened, and its pieces of at most ``CHUNK_BYTES``."""
        flat = t.contiguous().reshape(-1)
        step = max(1, CHUNK_BYTES // flat.element_size())
        return flat, [(i, min(i + step, flat.numel()))
                      for i in range(0, flat.numel(), step)]

    def all_gather(self, x: torch.Tensor, group) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new first axis."""
        buffers = self._buffers(group)
        flat, pieces = self._chunks(x)
        out = flat.new_empty((buffers.size, flat.numel()))
        for a, b in pieces:
            for j, part in enumerate(buffers.exchange(flat[a:b])):
                out[j, a:b] = part
        return out.view((buffers.size,) + tuple(x.shape))

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """The sum of every rank's ``t``, added in group-rank order."""
        buffers = self._buffers(group)
        flat, pieces = self._chunks(t)
        out = torch.empty_like(flat)
        for a, b in pieces:
            parts = buffers.exchange(flat[a:b])
            out[a:b] = parts[0]
            for p in parts[1:]:
                out[a:b].add_(p)
        return out.view(t.shape)

    def close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._groups.clear()


_CURRENT: List[Optional[CardWire]] = [None]


def usable(backend: str, device) -> bool:
    """True for gloo ranks on CUDA when the machine has one card (every
    rank then runs on it)."""
    return (backend == "gloo" and torch.device(device).type == "cuda"
            and torch.cuda.device_count() == 1)


def attach(device: torch.device) -> CardWire:
    _CURRENT[0] = CardWire(device)
    return _CURRENT[0]


def detach() -> None:
    if _CURRENT[0] is not None:
        _CURRENT[0].close()
    _CURRENT[0] = None


def release() -> None:
    """Drop every buffer of this rank's wire (the next collective of a
    group makes new ones).  Every rank of the groups calls it at the same
    point of its program, as a collective."""
    if _CURRENT[0] is not None:
        _CURRENT[0].close()


def for_tensor(t: torch.Tensor, group) -> Optional[CardWire]:
    """The wire when it carries ``t`` on ``group`` (a CUDA tensor on a
    gloo group of this card's ranks), else None."""
    wire = _CURRENT[0]
    if wire is None or not t.is_cuda or dist.get_backend(group) != "gloo":
        return None
    return wire
