"""Block autotuner of the port: the tile cap of the row-window sweeps.

The JAX package tunes the Pallas block size of each tiled sweep.  The
port's counterpart of that block is the TILE CAP of the four row-window
sweeps (``pipecg_spmv_fused`` / ``pipecg_spmv_halo``, #2 / #3, and
``pipebicgstab_fused`` / ``pipebicgstab_halo``, #8 / #9): the
``max_tile`` of ``pipecg_spmv_fused.window_plan``, which then picks the
CTA's tile, row windows and shared memory below it.  Two regimes, as in
the reference:

* modeled (the default): candidates are ranked by a modeled cost.  For
  the sweeps that is ``window_plan``'s own (batches of window slots per
  row, :func:`sweep_cost`), so among the candidates up to a sweep's
  default cap the choice is the default cap, and its plan is the one
  ``sweep_plan`` gives: tuning changes no tile of the main path.
  Without a ``cost`` the reference's :func:`modeled_words` ranks them.
* measured: with a caller-supplied ``probe(block) -> thunk`` on a card,
  each candidate's thunk is timed with CUDA events (median of ``reps``).
  Nothing of the port passes a probe, as nothing of the reference does.

Choices are cached per (kind, n, dtype, device name, min_block,
n_shards, k_rhs[, dtype_storage][, fmt][, offsets]) for the process
lifetime; the device's name (``torch.cuda.get_device_name``, or "cpu")
takes the place of the reference's backend, and the operator's offsets,
on which a sweep's plan depends, are appended like the reference's
optional parts.  ``save_cache`` / ``load_cache`` persist the table as
JSON (``build/repro_torch/autotune_cache.json`` by default);
``clear_cache`` and ``cache_stats`` exist for tests and for the serve
stage's hit/miss record.

One module consults it: ``pipecg_spmv_fused.device_plan``, which builds a
sweep's plan once per operator, shape, dtypes and device, looks the cap
up when it builds the plan, never at a launch (a key costs host time,
and one device is host-bound).  The plain versions on the CPU build no
plan and look nothing up.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import pipebicgstab_fused as _bicg
from repro_torch.kernels import pipecg_spmv_fused as _pcg
from repro_torch.kernels.build import BUILD_DIR

DEFAULT_CANDIDATES = (256, 512, 1024, 2048, 4096, 8192)
# modeled fixed cost of one grid step, expressed in words of equivalent
# memory traffic (launch + issue); only a tie-breaker
STEP_OVERHEAD_WORDS = 512

DEFAULT_CACHE_PATH = str(BUILD_DIR / "autotune_cache.json")

_CACHE: Dict[str, int] = {}
# hit/miss counters over the process lifetime: the serve stage's
# warm-reuse record ("second identical-shape request = pure hits")
_STATS: Dict[str, int] = {"hits": 0, "misses": 0}
# each tuning's (score, block) pairs, by key (chip_smoke prints them)
_SCORES: Dict[str, List[Tuple[float, int]]] = {}


def clear_cache() -> None:
    """Drop every cached block choice and reset counters (tests)."""
    _CACHE.clear()
    _SCORES.clear()
    _STATS["hits"] = 0
    _STATS["misses"] = 0


def cache_stats() -> Dict[str, int]:
    """Copy of the lifetime ``{"hits", "misses"}`` lookup counters."""
    return dict(_STATS)


def scores(key: str) -> List[Tuple[float, int]]:
    """The (score, block) pairs the tuning of ``key`` ranked (modeled
    cost, or measured milliseconds); empty for a loaded or unknown key."""
    return list(_SCORES.get(key, ()))


def device_name(device) -> str:
    """The cache's device part: the card's name, or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _key(kind: str, n: int, dtype, device: str, min_block: int,
         n_shards: int, k_rhs: int, dtype_storage=None,
         fmt: Optional[str] = None, offsets=None) -> str:
    """JSON-stable cache key: device name + full shape + dtype signature.

    ``dtype_storage``, ``fmt`` and ``offsets`` are appended only when set
    (the reference's append-only convention for extending the key).
    """
    parts = [kind, n, _dtype_name(dtype), device, min_block, n_shards,
             k_rhs]
    if dtype_storage is not None:
        parts.append(_dtype_name(dtype_storage))
    if fmt is not None:
        parts.append(str(fmt))
    if offsets is not None:
        parts.append(",".join(str(int(o)) for o in offsets))
    return "|".join(str(v) for v in parts)


def load_cache(path: str = DEFAULT_CACHE_PATH) -> int:
    """Merge a persisted cache file into the in-memory table.

    Returns the number of entries loaded (0 if the file is missing or
    unreadable: tuning then proceeds from scratch).
    """
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0
    loaded = 0
    for key, blk in data.get("blocks", {}).items():
        if isinstance(blk, int) and blk > 0:
            _CACHE.setdefault(key, blk)
            loaded += 1
    return loaded


def save_cache(path: str = DEFAULT_CACHE_PATH) -> str:
    """Write the in-memory table to ``path`` (creating parent dirs)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": 1, "blocks": _CACHE}, f, indent=2,
                  sort_keys=True)
    return path


def modeled_words(n: int, block: int, *, words_per_row: float,
                  resident_words: float = 0.0) -> float:
    """Modeled words moved by a tiled sweep over ``n`` padded rows."""
    n_pad = -(-n // block) * block
    steps = n_pad // block
    return (n_pad * words_per_row + resident_words
            + steps * STEP_OVERHEAD_WORDS)


def _measure(thunk: Callable[[], object], reps: int = 5) -> float:
    """Median CUDA-event milliseconds of ``thunk`` (one warm call first);
    the events bracket the thunk's host work too, so a candidate's time
    includes its launch."""
    thunk()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def best_block(kind: str, n: int, dtype, *,
               words_per_row: float = 0.0, resident_words: float = 0.0,
               cost: Optional[Callable[[int], float]] = None,
               min_block: int = 1,
               candidates: Sequence[int] = DEFAULT_CANDIDATES,
               probe: Optional[Callable[[int], Callable[[], object]]] = None,
               reps: int = 5, device="cuda",
               n_shards: int = 1, k_rhs: int = 1,
               dtype_storage=None, fmt: Optional[str] = None,
               offsets: Optional[Sequence[int]] = None) -> int:
    """Pick a block (a sweep's tile cap) for a tiled kernel sweep.

    kind            cache namespace (e.g. "pipecg_spmv")
    words_per_row   tiled words moved per (padded) row, for
                    :func:`modeled_words` when no ``cost`` is given
    resident_words  words fetched once per sweep regardless of block
    cost            block -> modeled cost (lower is better); given, the
                    candidates are not clamped to n (a tile cap above n
                    pads nothing: the plan's tile never exceeds its cap)
    min_block       hard floor
    probe           block -> thunk; with one, on a card, the candidates
                    are timed (median of ``reps`` CUDA-event runs)
    device          the caller's device (its name is part of the key)
    n_shards, k_rhs sharding degree and RHS batch of the caller
    dtype_storage   storage dtype when it differs from ``dtype``
    fmt, offsets    operator format and offsets, when they matter
    """
    dev = device_name(device)
    key = _key(kind, n, dtype, dev, min_block, n_shards, k_rhs,
               dtype_storage=dtype_storage, fmt=fmt, offsets=offsets)
    if key in _CACHE:
        _STATS["hits"] += 1
        return _CACHE[key]
    _STATS["misses"] += 1

    if cost is None:
        feasible = sorted({min(c, n) for c in candidates
                           if min(c, n) >= min_block})
    else:
        feasible = sorted({c for c in candidates if c >= min_block})
    if not feasible:
        feasible = [max(n, min_block)]

    if probe is not None and dev != "cpu":
        scored = [(_measure(probe(b), reps), b) for b in feasible]
    elif cost is not None:
        scored = [(float(cost(b)), b) for b in feasible]
    else:
        scored = [(modeled_words(n, b, words_per_row=words_per_row,
                                 resident_words=resident_words), b)
                  for b in feasible]
    # min score; ties resolved toward the LARGER block (fewer CTAs)
    best = min(scored, key=lambda sb: (sb[0], -sb[1]))[1]
    _CACHE[key] = best
    _SCORES[key] = scored
    return best


#: sweep -> (cache kind, its plan, its default tile cap)
_SWEEPS = {"pipecg": ("pipecg_spmv", _pcg.sweep_plan, _pcg.SWEEP_TILE),
           "pipebicgstab": ("pipebicgstab", _bicg.sweep_plan,
                            _bicg.BICG_TILE)}


def sweep_of(plan: Callable) -> str:
    """The sweep ("pipecg" or "pipebicgstab") whose plan is ``plan``."""
    (name,) = [k for k, v in _SWEEPS.items() if v[1] is plan]
    return name


def sweep_key(sweep: str, offsets: Sequence[int], n: int, dtype, *,
              device="cuda", n_shards: int = 1, k_rhs: int = 1,
              dtype_storage=None) -> str:
    """The cache key :func:`sweep_tile_cap` looks up."""
    return _key(_SWEEPS[sweep][0], n, dtype, device_name(device), 1,
                n_shards, k_rhs, dtype_storage=dtype_storage,
                offsets=offsets)


def sweep_cost(sweep: str, offsets: Sequence[int], acc_bytes: int,
               max_tile: int) -> float:
    """``window_plan``'s cost (batches per row) of the plan at a cap."""
    tile, table, _ = _SWEEPS[sweep][1](offsets, acc_bytes, max_tile)
    return _pcg.plan_cost(tile, table)


def sweep_candidates(sweep: str) -> Tuple[int, ...]:
    """The tile caps a sweep is tuned over: the default candidates up to
    its default cap (``SWEEP_TILE`` for PIPECG, ``BICG_TILE`` for
    p-BiCGStab)."""
    return tuple(c for c in DEFAULT_CANDIDATES if c <= _SWEEPS[sweep][2])


def sweep_tile_cap(sweep: str, offsets: Sequence[int], n: int, dtype, *,
                   device="cuda", n_shards: int = 1, k_rhs: int = 1,
                   dtype_storage=None, probe=None, reps: int = 5) -> int:
    """The tile cap of a row-window sweep (``sweep`` "pipecg" or
    "pipebicgstab") on ``offsets`` over ``n`` (local) rows at the
    accumulator ``dtype``: one :func:`best_block` lookup."""
    acc_bytes = torch.empty((), dtype=dtype).element_size()
    offs = tuple(int(o) for o in offsets)
    return best_block(
        _SWEEPS[sweep][0], n, dtype,
        cost=lambda cap: sweep_cost(sweep, offs, acc_bytes, cap),
        candidates=sweep_candidates(sweep), probe=probe, reps=reps,
        device=device, n_shards=n_shards, k_rhs=k_rhs,
        dtype_storage=dtype_storage, offsets=offs)
