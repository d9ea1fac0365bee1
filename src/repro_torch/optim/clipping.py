"""Global-norm gradient clipping — synchronous and PIPELINED variants.

The port of the JAX package's ``optim/clipping.py``.  The pipelined
variant is the paper's split-phase collective applied to training: the
global-norm reduction initiated at step k is *consumed at step k+1* (its
value is carried in the train state as ``prev_gnorm``), so the reduction
no longer serialises the optimizer update against the full gradient tree
(``distributed/overlap.py``'s ``DelayedValue`` in optimizer form).

Cost of the rearrangement (mirroring the Krylov case): one step of
staleness in the clip threshold, arithmetically identical whenever the
norm stays below the threshold.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import torch

Tree = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def _leaves(tree: Tree):
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def _scale(tree: Tree, scale: torch.Tensor) -> Tree:
    def one(g):
        return (g.float() * scale.to(g.device)).to(g.dtype)
    if isinstance(tree, Mapping):
        return {k: one(g) for k, g in tree.items()}
    return [one(g) for g in tree]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (fp32, leaf order)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in _leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float, norm=None):
    """Synchronous clipping: the norm gates every update (classical
    CG-style data dependency).  Returns (clipped_grads, norm).  ``norm``:
    the tree's global norm when the caller computed it (the blocks of a
    sharded gradient, ``distributed/sharding.py::global_norm``)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _scale(grads, scale), norm


def clip_by_delayed_norm(grads: Tree, prev_norm: torch.Tensor,
                         max_norm: float, norm=None):
    """Pipelined clipping: clip with the PREVIOUS step's norm; return this
    step's norm for the next step (split-phase collective).

    Returns (clipped_grads, this_norm).  ``prev_norm <= 0`` (first step)
    clips with ``max_norm`` itself, i.e. not at all.  ``norm`` as for
    :func:`clip_by_global_norm`.
    """
    if norm is None:  # reduction initiated now, consumed next step
        norm = global_norm(grads)
    prev = torch.as_tensor(prev_norm, dtype=torch.float32).to(norm.device)
    safe_prev = torch.where(prev > 0, prev, torch.full_like(prev, max_norm))
    scale = torch.clamp(max_norm / torch.clamp(safe_prev, min=1e-9), max=1.0)
    return _scale(grads, scale), norm
