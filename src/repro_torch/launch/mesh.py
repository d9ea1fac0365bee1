"""Device meshes: named axes over the ranks of one process group.

The port of the JAX package's ``launch/mesh.py``.  A :class:`Mesh` has
``axis_names`` and ``shape`` (a name -> size mapping), as the reference's
``jax.sharding.Mesh`` does.  A mesh built over live ranks
(:func:`make_host_mesh`) also knows this rank's coordinate on each axis
and holds one process group per set of axes: for every set, the ranks
that share their coordinates on the other axes.  Ranks are laid out
row-major, the last axis fastest (rank ``r`` of a ``(data, model)`` mesh
sits at ``(r // model, r % model)``), so a group's ranks in ascending
order are its blocks in order along any tuple of axes named in mesh
order.

``make_production_mesh`` is a function, not a module constant: importing
this module touches no device or process-group state.
"""
from __future__ import annotations

import itertools
from typing import Dict, Mapping, Optional, Tuple

import torch.distributed as dist

Axes = Tuple[str, ...]


class Mesh:
    """Named axes of ``shape`` (insertion order is the axis order).

    ``rank`` is None for a mesh of shapes only (the production meshes);
    a live mesh (:meth:`live`) has this rank's coordinates and groups.
    """

    def __init__(self, shape: Mapping[str, int], rank: Optional[int] = None):
        self.axis_names: Axes = tuple(shape)
        self.shape: Dict[str, int] = {a: int(shape[a])
                                      for a in self.axis_names}
        self.size = 1
        for a in self.axis_names:
            self.size *= self.shape[a]
        self.rank = rank
        self.coords: Optional[Dict[str, int]] = None
        self._groups: Dict[Axes, object] = {}
        if rank is not None:
            self.coords = self._coords_of(rank)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        where = "" if self.rank is None else f", rank={self.rank}"
        return f"Mesh({dims}{where})"

    def _coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def axes(self, axes) -> Axes:
        """``axes`` (a name, a tuple of names or None) as a tuple, checked
        to be in mesh order."""
        if axes is None:
            return ()
        t = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in t]
        if order != sorted(order):
            raise ValueError(f"axes {t} are not in mesh order "
                             f"{self.axis_names}")
        return t

    def count(self, axes) -> int:
        """Number of blocks along ``axes`` (1 for none)."""
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's block along ``axes``: its coordinates read as one
        mixed-radix number, the first axis most significant."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (None: the default group, when that is all ranks)."""
        return self._groups[self.axes(axes)]

    @classmethod
    def live(cls, shape: Mapping[str, int]) -> "Mesh":
        """A mesh over the ranks of the default process group (or over
        this one process when none is initialised).  Every rank must call
        it with the same shape and at the same point: it creates the
        groups of every set of axes, in one order on every rank."""
        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            rank, world = 0, 1
        mesh = cls(shape, rank)
        if mesh.size != world:
            raise ValueError(f"a mesh of {mesh.size} ranks over a group of "
                             f"{world}")
        names = mesh.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                mesh._groups[axes] = mesh._make_group(axes, world)
        return mesh

    def _make_group(self, axes: Axes, world: int):
        if self.count(axes) == 1 or world == 1:
            return None                       # no communication needed
        if self.count(axes) == world:
            return None                       # the default group
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        lines: Dict[tuple, list] = {}
        for r in range(world):
            c = self._coords_of(r)
            lines.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(lines):
            g = dist.new_group(ranks=lines[key])
            if self.rank in lines[key]:
                mine = g
        return mine


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a 'pod' axis
    (shapes only: no ranks)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh(model: int = 1) -> Mesh:
    """``(world // model, model)`` over the default process group (one
    rank when none is initialised)."""
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if world % model:
        raise ValueError(f"{world} ranks do not split into model={model}")
    return Mesh.live({"data": world // model, "model": model})

