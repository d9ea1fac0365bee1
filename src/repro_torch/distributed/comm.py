"""The wire the many-rank solves talk over: ``torch.distributed``.

A collective or point-to-point call takes tensors on the device its
backend serves.  NCCL reads device memory, so device tensors go as they
are.  Gloo reads host memory: a CUDA tensor on a gloo group goes through
an explicit host copy each way (never a CUDA pointer handed to gloo), as
do strips sliced from a vector, which must be contiguous.  Every helper
here takes a process ``group`` (None: the default group) and works in
that group's ranks.  A 2-D process grid is the same group read row-major:
rank r sits at grid position ``(r // px, r % px)``, and
:func:`exchange_along` names the two neighbours along one grid axis.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def rank_and_size(group=None) -> Tuple[int, int]:
    """This process's rank in ``group`` and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def global_rank(group, rank: int) -> int:
    """Global rank of ``group``'s member ``rank`` (point-to-point peers)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def host_staged(device: torch.device, group=None) -> bool:
    """True when tensors on ``device`` travel through host copies."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def to_wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """A contiguous copy of ``t`` on the wire's side (host if staged)."""
    if staged:
        return t.to("cpu", memory_format=torch.contiguous_format)
    return t.clone(memory_format=torch.contiguous_format)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (or, ``op="max"``, maximum) of ``t`` over the group (blocking);
    returns a new tensor.

    ``all_reduce.calls`` counts the calls, so a test can read how many
    blocking reductions a solve issued.
    """
    all_reduce.calls += 1
    buf = to_wire(t, host_staged(t.device, group))
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return buf.to(t.device)


all_reduce.calls = 0


def all_gather_cols(x: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along its last axis, in rank order.

    Each rank holds an equal number of columns (rows of the operator).
    """
    staged = host_staged(x.device, group)
    buf = to_wire(x, staged)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]], group=None) -> None:
    """Post every send and receive at once, then wait for all of them.

    ``sends`` and ``recvs`` pair a group rank with a wire tensor; the
    receive buffers are filled in place.  ``exchange.bytes`` sums the
    bytes sent, by dtype name, so a test can read what went on the wire.
    """
    for _, t in sends:
        key = str(t.dtype).replace("torch.", "")
        exchange.bytes[key] = exchange.bytes.get(key, 0) \
            + t.numel() * t.element_size()
    ops = [dist.P2POp(dist.isend, t, global_rank(group, r), group)
           for r, t in sends]
    ops += [dist.P2POp(dist.irecv, t, global_rank(group, r), group)
            for r, t in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


exchange.bytes = {}


def exchange_along(v: torch.Tensor, w: int, axis: int, low, high,
                   group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge strips of width ``w`` along ``axis`` from two neighbours.

    ``low`` and ``high`` are group ranks (None: no neighbour there).
    Returns ``(from_low, from_high)``: the last ``w`` entries along
    ``axis`` of ``low``'s ``v`` and the first ``w`` of ``high``'s, zeros
    where there is no neighbour (the zero extension at the matrix edge).
    This rank sends its first ``w`` entries to ``low`` and its last ``w``
    to ``high`` in the same exchange.
    """
    shape = list(v.shape)
    shape[axis] = w
    if w == 0:
        low = high = None
    staged = host_staged(v.device, group)
    ext = v.shape[axis]
    sends, recvs, bufs = [], [], {}
    for peer, start in ((low, 0), (high, ext - w)):
        if peer is None:
            continue
        bufs[peer] = wire_buffer(shape, v, staged)
        sends.append((peer, to_wire(v.narrow(axis, start, w), staged)))
        recvs.append((peer, bufs[peer]))
    exchange(sends, recvs, group)

    # a strip that arrived is used as it is; zeros only where none did
    def received(peer):
        if peer is None:
            return torch.zeros(shape, dtype=v.dtype, device=v.device)
        return bufs[peer].to(v.device)

    return received(low), received(high)


def wire_buffer(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty receive buffer of ``like``'s dtype on the wire's side."""
    dev = torch.device("cpu") if staged else like.device
    return torch.empty(shape, dtype=like.dtype, device=dev)
