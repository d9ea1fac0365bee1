"""Deterministic, resumable synthetic token pipeline.

The port of the JAX package's ``data/synthetic.py``.  Stateless
index-based generation: batch ``i`` is a pure function of (seed, i), so
restart-from-checkpoint reproduces the exact stream with no stored
iterator state.

The stream mixes Zipfian unigrams with an order-2 Markov chain (token
t+1 follows ``perm[t]`` with probability 1/2) so a small model shows a
real learning curve.  The Zipf logits and ``perm`` come from numpy exactly
as in the reference, so they are bit-equal to its; the categorical and
Bernoulli draws come from a ``torch.Generator`` seeded from (seed, step)
on the host, where the reference draws with ``jax.random``, so the
streams differ but keep the same contract.  Batches are drawn on the CPU
(the same batches whatever the device) and moved to ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_codebooks: int = 1
    frontend_positions: int = 0
    d_model: int = 0           # for frontend embedding stubs
    zipf_alpha: float = 1.1


def _zipf_logits(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return np.log(p / p.sum())


def step_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step``: a pure function of both."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> 1)


class SyntheticTokens:
    """batch(i) -> {'tokens', 'labels'[, 'frontend']} for step i."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        logits = _zipf_logits(cfg.vocab_size, cfg.zipf_alpha)
        self._logits = torch.from_numpy(logits.astype(np.float32))
        self._probs = torch.from_numpy(np.exp(logits))
        # order-2 structure: t_{i+1} = perm[t_i] with prob q, else zipf draw
        rng = np.random.default_rng(cfg.seed)
        self._perm = torch.from_numpy(
            rng.permutation(cfg.vocab_size).astype(np.int32))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        g = torch.Generator().manual_seed(step_seed(cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        shape = (B, S + 1) if cfg.num_codebooks == 1 else \
            (B, S + 1, cfg.num_codebooks)
        n = int(np.prod(shape))
        base = torch.multinomial(self._probs, n, replacement=True,
                                 generator=g).reshape(shape)
        # markov mixing along S
        follow = self._perm.long()[base]
        gate = torch.rand(shape, generator=g) < 0.5
        mixed = torch.where(gate, torch.roll(follow, 1, dims=1), base)
        out = {"tokens": mixed[:, :-1].to(torch.int32),
               "labels": mixed[:, 1:].to(torch.int32)}
        if cfg.frontend_positions:
            out["frontend"] = 0.02 * torch.randn(
                (B, cfg.frontend_positions, cfg.d_model), generator=g,
                dtype=torch.bfloat16)
        return {k: v.to(self.device) for k, v in out.items()}

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        i = step
        while True:
            yield self.batch(i)
            i += 1
