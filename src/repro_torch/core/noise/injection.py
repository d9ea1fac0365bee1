"""Wall-clock noise injection for real solver runs.

The paper measures solvers under ambient OS noise.  A ``NoiseHook``
injects its own: called once per Krylov iteration on each rank, it sleeps
a freshly sampled waiting time on the host, on the iteration's critical
path (core/krylov/distributed.py calls it between the kernel launch and
the issue of the iteration's reduction, so every other rank waits for it
at the next wait).  Every iteration stalls for ``scale * W`` seconds with
``W ~ dist``: the T_p = t_compute + W_p decomposition of the paper's Eq.
(6)/(7).  The hook records every sample it injects.

**Determinism.** Rank (shard) ``s`` draws from its own numpy substream
seeded ``(seed, s)``, as the JAX package's hook does, so for one seed both
packages inject the same waits bit for bit.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.perfmodel.distributions import Distribution


class NoiseHook:
    """Samples waiting times from ``dist`` and sleeps them on the host.

    ``dist`` is the waiting-time distribution in dimensionless draws (None
    disables the draw); ``scale`` converts a draw to seconds
    (``scale=1e-3`` with ``Exponential(1.0)`` injects exponential waits
    with a 1 ms mean); ``seed`` seeds the host numpy substreams, shard
    ``s`` drawing from ``(seed, s)``.  Each call advances the calling
    shard's substream and appends the wait (seconds) to
    ``shard_record[shard]``.  Each rank is its own process and calls only
    its own shard.
    """

    def __init__(self, dist: Optional[Distribution], scale: float = 1e-3,
                 seed: int = 0):
        self.dist = dist
        self.scale = float(scale)
        self.seed = int(seed)
        self._rngs: Dict[int, np.random.Generator] = {}
        self.shard_record: Dict[int, List[float]] = {}

    def _draw(self, shard: int) -> float:
        """One wait (seconds) from ``shard``'s substream."""
        from repro_torch.core.noise.sampling import sample_np
        rng = self._rngs.get(shard)
        if rng is None:
            rng = self._rngs[shard] = np.random.default_rng((self.seed, shard))
        return float(sample_np(self.dist, rng, ())) * self.scale

    def _record(self, shard: int, w: float) -> None:
        self.shard_record.setdefault(shard, []).append(w)

    def sample(self, shard: int = 0) -> float:
        """Draw one waiting time in seconds (records it, does not sleep)."""
        shard = int(shard)
        w = 0.0 if self.dist is None else self._draw(shard)
        self._record(shard, w)
        return w

    def __call__(self, shard: int = 0) -> None:
        """Sleep a sampled wait on the host; ``shard`` is the caller's
        rank and selects the substream.  Returns None: a plain hook adds
        nothing to the solve (a fault injector returns a tick)."""
        time.sleep(self.sample(shard))

    def shard_waits(self, shard: int) -> np.ndarray:
        """Injected waits of one logical shard, in call order (seconds)."""
        return np.asarray(self.shard_record.get(int(shard), ()), np.float64)


def make_noise_hook(dist: Optional[Distribution], scale: float = 1e-3,
                    seed: int = 0) -> Optional[NoiseHook]:
    """``NoiseHook`` factory that forwards ``None`` (= no injection)."""
    if dist is None:
        return None
    return NoiseHook(dist, scale=scale, seed=seed)
