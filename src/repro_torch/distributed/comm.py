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

Host copies land in pinned memory, so that the copy back to the card is
asynchronous (:func:`from_wire`): a solve's iteration then blocks on the
card once per strip exchange and not once per strip.  Where this process
maps the shared-memory wire of its spawned gloo ranks
(distributed/shm.py), the sums and strips of the whole group go through
it and not through gloo's sockets; every helper here first publishes
the sums this rank has posted to it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.autograd import Function

from repro_torch.distributed import card_wire, shm


def rank_and_size(group=None) -> Tuple[int, int]:
    """This process's rank in ``group`` and the group's size."""
    return dist.get_rank(group), dist.get_world_size(group)


def global_rank(group, rank: int) -> int:
    """Global rank of ``group``'s member ``rank`` (point-to-point peers)."""
    return rank if group is None else dist.get_global_rank(group, rank)


def host_staged(device: torch.device, group=None) -> bool:
    """True when tensors on ``device`` travel through host copies."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def wire_for(group):
    """The shared-memory wire when it carries ``group`` (the whole group of
    spawned gloo ranks), else None."""
    wire = shm.current()
    if wire is None or not (group is None or group is dist.group.WORLD):
        return None
    return wire


def flush() -> None:
    """Publish the sums this rank has posted to its wire (if any)."""
    wire = shm.current()
    if wire is not None:
        wire.flush()


def to_wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """A contiguous copy of ``t`` on the wire's side: pinned host memory
    if staged (a blocking copy), else a clone."""
    if staged:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t)
    return t.clone(memory_format=torch.contiguous_format)


def from_wire(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``buf`` on ``device``; from pinned memory the copy does not block
    the host (the card's stream orders it before what reads it)."""
    return buf.to(device, non_blocking=buf.is_pinned())


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (or, ``op="max"``, maximum) of ``t`` over the group (blocking);
    returns a new tensor.

    ``all_reduce.calls`` counts the calls, so a test can read how many
    blocking reductions a solve issued, and ``all_reduce.bytes`` the bytes
    of the tensors this rank handed in.
    """
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()
    buf = to_wire(t, host_staged(t.device, group))
    wire = wire_for(group)
    if wire is not None and buf.device.type == "cpu" and wire.fits(buf):
        wire.result(wire.post(buf), buf, op)
    else:
        flush()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
    return from_wire(buf, t.device)


all_reduce.calls = 0
all_reduce.bytes = 0


def all_gather_cols(x: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along its last axis, in rank order.

    Each rank holds an equal number of columns (rows of the operator).
    """
    staged = host_staged(x.device, group)
    buf = to_wire(x, staged)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    flush()
    dist.all_gather(parts, buf, group=group)
    return from_wire(torch.cat(parts, dim=-1), x.device)


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]], group=None) -> None:
    """Post every send and receive at once, then wait for all of them.

    ``sends`` and ``recvs`` pair a group rank with a wire tensor; the
    receive buffers are filled in place.  A message that fits a slot of
    the group's shared-memory wire goes through it (both ends see the
    same size, so both choose alike), any other through gloo.
    ``exchange.bytes`` sums the bytes sent, by dtype name, so a test can
    read what went on the wire.
    """
    for _, t in sends:
        key = str(t.dtype).replace("torch.", "")
        exchange.bytes[key] = exchange.bytes.get(key, 0) \
            + t.numel() * t.element_size()
    wire = wire_for(group)

    def shared(t):
        return wire is not None and t.device.type == "cpu" and wire.fits(t)

    flush()
    ops = [dist.P2POp(dist.isend, t, global_rank(group, r), group)
           for r, t in sends if not shared(t)]
    ops += [dist.P2POp(dist.irecv, t, global_rank(group, r), group)
            for r, t in recvs if not shared(t)]
    works = dist.batch_isend_irecv(ops) if ops else []
    for r, t in sends:
        if shared(t):
            wire.send(r, t)
    for r, t in recvs:
        if shared(t):
            wire.recv(r, t)
    for work in works:
        work.wait()


exchange.bytes = {}


def exchange_along(v, w: int, axis: int, low, high, group=None):
    """Edge strips of width ``w`` along ``axis`` from two neighbours.

    ``low`` and ``high`` are group ranks (None: no neighbour there).
    Returns ``(from_low, from_high)``: the last ``w`` entries along
    ``axis`` of ``low``'s ``v`` and the first ``w`` of ``high``'s, zeros
    where there is no neighbour (the zero extension at the matrix edge).
    This rank sends its first ``w`` entries to ``low`` and its last ``w``
    to ``high`` in the same exchange.  ``v`` may also be a list of
    tensors of one shape and dtype: then every strip of every vector
    leaves in one copy off the card and one message a face, and the
    result is a list of such pairs, one a vector.
    ``exchange_along.sends`` counts the strips sent by face,
    ``"<axis>:lo"`` / ``"<axis>:hi"``: one per vector and face.
    """
    many = isinstance(v, (list, tuple))
    vs = list(v) if many else [v]
    x0 = vs[0]
    shape = list(x0.shape)
    shape[axis] = w
    if w == 0:
        low = high = None
    staged = host_staged(x0.device, group)
    ext = x0.shape[axis]
    faces = [(peer, start) for peer, start in ((low, 0), (high, ext - w))
             if peer is not None]
    arrived = None
    if faces:
        strips = torch.stack([x.narrow(axis, start, w)
                              for _, start in faces for x in vs]
                             ).view([len(faces), len(vs)] + shape)
        host = to_wire(strips, True) if staged else strips
        got = wire_buffer(list(host.shape), x0, staged)
        for _, start in faces:
            face = f"{axis}:{'lo' if start == 0 else 'hi'}"
            exchange_along.sends[face] = \
                exchange_along.sends.get(face, 0) + len(vs)
        exchange([(peer, host[k]) for k, (peer, _) in enumerate(faces)],
                 [(peer, got[k]) for k, (peer, _) in enumerate(faces)],
                 group)
        arrived = from_wire(got, x0.device)

    # a strip that arrived is used as it is; zeros only where none did
    def received(peer, at, j):
        if peer is None:
            return torch.zeros(shape, dtype=x0.dtype, device=x0.device)
        return arrived[at][j]

    lo_at, hi_at = 0, (1 if low is not None else 0)
    pairs = [(received(low, lo_at, j), received(high, hi_at, j))
             for j in range(len(vs))]
    return pairs if many else pairs[0]


exchange_along.sends = {}


def wire_buffer(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty receive buffer of ``like``'s dtype on the wire's side
    (pinned host memory if staged)."""
    if staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Collectives along the axes of a mesh (launch/mesh.py), for sharded models
# ---------------------------------------------------------------------------
#
# A sharded model's ranks hold blocks of its parameters and rows of its
# batch.  The gradient a rank's backward pass produces is its contribution:
# the derivative of the loss through its own batch rows.  Ranks that hold
# the same rows (a ``model`` line under the "2d" strategy) compute the same
# contribution, so contributions are summed over the batch axes and over no
# other axis.  Every function below skips its communication when the axes
# hold one block.

def all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (through the card's IPC buffers where ``card_wire`` carries it).

    ``all_gather.bytes`` counts the bytes this rank received,
    ``all_gather.calls`` the calls.
    """
    all_gather.calls += 1
    all_gather.bytes += (size - 1) * x.numel() * x.element_size()
    moved = x.movedim(dim, 0)
    wire = card_wire.for_tensor(x, group)
    if wire is not None:
        out = wire.all_gather(moved, group).flatten(0, 1)
        return out.movedim(0, dim).contiguous()
    staged = host_staged(x.device, group)
    buf = to_wire(moved, staged)
    parts = [torch.empty_like(buf) for _ in range(size)]
    flush()
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts).movedim(0, dim)
    return from_wire(out.contiguous(), x.device)


all_gather.bytes = 0
all_gather.calls = 0


def own_block(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` split over ``axes``."""
    n = mesh.count(axes)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {n} blocks over {axes}")
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * size, size)


def _sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh.count(axes) == 1:
        return t
    group = mesh.group(axes)
    wire = card_wire.for_tensor(t, group)
    if wire is None:
        return all_reduce(t, group)
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()
    return wire.all_reduce(t, group)


class _Gather(Function):
    """Forward: the whole tensor from this rank's block (an all-gather per
    split dimension).  Backward: the block of the summed contributions,
    the incoming gradient sliced along the dimensions split over axes that
    are not batch axes (every rank of a batch group holds the same
    coordinates there), summed over the batch axes, then sliced along the
    rest.  The sum is an all-reduce of the once-sliced gradient followed by
    a slice (a first form of a reduce-scatter)."""

    @staticmethod
    def forward(ctx, block, mesh, dims, batch_axes):
        ctx.mesh, ctx.dims, ctx.batch_axes = mesh, dims, batch_axes
        out = block
        for dim, axes in dims:
            n = mesh.count(axes)
            if n > 1:
                out = all_gather(out, dim, mesh.group(axes), n)
        return out if out is not block else block.view_as(block)

    @staticmethod
    def backward(ctx, g):
        mesh, bt = ctx.mesh, set(ctx.batch_axes)
        for dim, axes in ctx.dims:
            if not bt & set(mesh.axes(axes)):
                g = own_block(g, dim, mesh, axes)
        g = _sum(g.contiguous(), mesh, ctx.batch_axes)
        for dim, axes in ctx.dims:
            if bt & set(mesh.axes(axes)):
                g = own_block(g, dim, mesh, axes)
        return g.contiguous(), None, None, None


def gather_blocks(block: torch.Tensor, mesh, dims, batch_axes
                  ) -> torch.Tensor:
    """The tensor whose block along each ``(dim, axes)`` of ``dims`` this
    rank holds, differentiable (:class:`_Gather`); with no ``dims`` the
    block itself, its gradient summed over ``batch_axes``."""
    return _Gather.apply(block, mesh, tuple(dims), tuple(batch_axes))


class _SumOver(Function):
    """Forward: the sum over ``axes``.  Backward: the incoming gradient
    as it is (each rank's use of the sum is its own contribution)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _sum(t, mesh, axes) if mesh.count(axes) > 1 \
            else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyOver(Function):
    """Forward: the tensor as it is.  Backward: the gradient summed over
    ``axes`` (ranks that each use the tensor for a part of the work)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _OwnPart(Function):
    """Forward: this rank's block along ``dim`` of a tensor that every
    rank of ``axes`` holds whole.  Backward: every rank's block gradient
    gathered (each rank used its own block of the same tensor)."""

    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return own_block(t, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.count(ctx.axes)
        if n > 1:
            g = all_gather(g.contiguous(), ctx.dim, ctx.mesh.group(ctx.axes),
                           n)
        return g, None, None, None


def own_part(t: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``t`` (whole on every rank of ``axes``) along
    ``dim``; the backward gathers the blocks' gradients."""
    return _OwnPart.apply(t, dim, mesh, tuple(axes))


def sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``t`` over ``axes``; the backward passes the gradient on."""
    return _SumOver.apply(t, mesh, tuple(axes))


def copy_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` itself; the backward sums the gradient over ``axes``."""
    return _CopyOver.apply(t, mesh, tuple(axes))


class _BatchMean(Function):
    @staticmethod
    def forward(ctx, value, weight, mesh, axes):
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=value.device)
        both = _sum(torch.stack([value.float() * w, w]), mesh, axes)
        total = torch.clamp(both[1], min=1.0)
        ctx.scale = w / total
        return (both[0] / total).to(value.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g.float() * ctx.scale).to(g.dtype), None, None, None


def batch_mean(value: torch.Tensor, weight, mesh, axes) -> torch.Tensor:
    """The mean over the batch blocks along ``axes`` of a 0-d ``value``
    weighted by ``weight`` (a count: tokens, or unmasked positions; the
    total is clamped to 1, as ``cross_entropy``'s own count).  The
    backward gives this rank's ``value`` the gradient scaled by its share
    ``weight / total``: the derivative of the mean through it alone."""
    return _BatchMean.apply(value, weight, mesh, tuple(axes))
