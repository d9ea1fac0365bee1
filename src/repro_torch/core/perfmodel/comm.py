"""Surface-to-volume halo-communication terms for d-dimensional grids.

The paper's per-iteration model (Eq. 6/7) prices the neighbour exchange
of a 1-D chain decomposition as a fixed ``2 * halo`` elements per vector.
This module generalizes that wire term to a d-dimensional process grid:
a rank owning a local tile of extents ``(e_1, .., e_d)`` exchanges, per
halo-carrying vector, one strip per face,

    messages  = 2 * d                      (N/S/W/E pairs for d = 2)
    elements  = sum_i 2 * w_i * prod_{j != i} e_j

the classical surface-to-volume law.  ``halo_wire_time`` folds the counts
into ``bytes / link_bw + latency``; for ``d = 1`` it is the 1-D chain's
value.  The sharded bodies realize the same counts: ``HaloSpec``
(core/krylov/operator.py) names the faces, and
``distributed.halo_exchange_2d`` sends ``2 * d`` strips per field.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple


def local_extents(points: Sequence[int],
                  grid: Sequence[int]) -> Tuple[int, ...]:
    """Per-shard tile extents of a ``points`` lattice over a process grid.

    ``points`` are the global lattice extents (e.g. ``(ny, nx)``) and
    ``grid`` the process counts per dimension (e.g. ``(py, px)``); each
    dimension must tile evenly, as the sharded bodies require.
    """
    if len(points) != len(grid):
        raise ValueError(f"rank mismatch: points {tuple(points)} vs grid "
                         f"{tuple(grid)}")
    for npts, g in zip(points, grid):
        if g <= 0 or npts % g:
            raise ValueError(
                f"lattice {tuple(points)} does not tile evenly over "
                f"process grid {tuple(grid)}")
    return tuple(int(npts) // int(g) for npts, g in zip(points, grid))


def halo_messages(ndim: int) -> int:
    """Strip messages per exchanged vector for an interior rank.

    Two faces per dimension — the ``HaloSpec.messages_per_exchange`` of
    the matching operator decomposition.
    """
    return 2 * int(ndim)


def halo_elems(extents: Sequence[int], widths: Sequence[int]) -> int:
    """Halo elements per exchanged vector: ``sum_i 2 w_i prod_{j!=i} e_j``.

    ``extents`` are the local tile extents, ``widths`` the halo strip
    widths per dimension.  For a 1-D chain this is the historical
    ``2 * halo``; for a 2-D tile, ``2*(wy*lx + wx*ly)`` — the tile's
    surface, scaled by the stencil reach.
    """
    if len(extents) != len(widths):
        raise ValueError(f"rank mismatch: extents {tuple(extents)} vs "
                         f"widths {tuple(widths)}")
    total = 0
    for i, w in enumerate(widths):
        perp = math.prod(e for j, e in enumerate(extents) if j != i)
        total += 2 * int(w) * perp
    return total


def surface_to_volume(extents: Sequence[int],
                      widths: Sequence[int]) -> float:
    """Halo elements per owned lattice site (the surface-to-volume ratio).

    The dimensionless knob of the geometry sweep: for a fixed shard
    volume it is minimized by the process grid that keeps the tile
    closest to a cube — exactly what :func:`best_grid` searches.
    """
    return halo_elems(extents, widths) / float(math.prod(extents))


def halo_wire_time(extents: Sequence[int], widths: Sequence[int], *,
                   n_halo_vecs: int, dtype_bytes: int,
                   wire_words: float = 1.0, link_bw: float,
                   hop_latency: float) -> float:
    """Neighbor-exchange seconds: surface bytes on the link + face latency.

    ``bytes = halo_elems * n_halo_vecs * dtype_bytes * wire_words`` rides
    the card's link bandwidth; each dimension contributes one
    send/receive latency pair, serialized (the two phases of the
    corner-carrying exchange cannot overlap — phase 2 forwards phase 1's
    rows).  For ``d = 1`` this is ``SolverPhaseModel.t_halo``'s chain
    value.
    """
    elems = halo_elems(extents, widths)
    bytes_wire = elems * n_halo_vecs * dtype_bytes * wire_words
    return bytes_wire / link_bw + 2.0 * len(tuple(widths)) * hop_latency


def _factorizations(p: int, ndim: int):
    """Yield every ordered factorization of ``p`` into ``ndim`` factors."""
    if ndim == 1:
        yield (p,)
        return
    for d in range(1, p + 1):
        if p % d == 0:
            for rest in _factorizations(p // d, ndim - 1):
                yield (d,) + rest


def best_grid(points: Sequence[int], p: int,
              widths: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Process grid over ``points`` minimizing the per-shard halo surface.

    Enumerates every ordered factorization of ``p`` with one factor per
    lattice dimension, keeps those that tile ``points`` evenly and leave
    every local extent at least ``2 * width`` (the bodies' stencil-reach
    floor), and returns the one with the fewest halo elements
    (:func:`halo_elems`; ties break toward the earlier dimensions).
    ``widths`` defaults to 1 per dimension.
    """
    pts = tuple(int(x) for x in points)
    w = tuple(int(x) for x in (widths if widths is not None
                               else (1,) * len(pts)))
    best: Optional[Tuple[int, ...]] = None
    best_cost = None
    for grid in _factorizations(int(p), len(pts)):
        if any(npts % g for npts, g in zip(pts, grid)):
            continue
        ext = tuple(npts // g for npts, g in zip(pts, grid))
        if any(e < 2 * wi for e, wi in zip(ext, w)):
            continue
        cost = halo_elems(ext, w)
        if best_cost is None or cost < best_cost:
            best, best_cost = grid, cost
    if best is None:
        raise ValueError(
            f"no process grid of {p} shards tiles lattice {pts} with "
            f"local extents >= 2*widths {w}")
    return best
