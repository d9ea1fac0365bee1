"""int8 wire compression: gradients, halo strips, carried Gram payloads.

Two consumers share one quantizer:

* a gradient all-reduce across hosts: int8 with per-tensor scales sends a
  quarter of fp32's bytes (:func:`compress_tree`, :func:`compressed_grads`
  on nested dicts and lists of tensors);
* the pipelined solvers' wire (``PrecisionPolicy(wire='int8')``):
  :func:`compress_halo` shrinks the 2h strips the sharded bodies exchange
  every iteration, and :func:`compress_gram` the carried split-phase
  reduction payload (core/krylov/distributed.py).

Error feedback (Seide et al.) keeps the quantization residual at the
SENDER and adds it to the next payload, so the compressed trajectory
tracks the exact one; without it the per-iteration error accumulates
into the attainable-accuracy floor.  The ABFT checksum entry of a Gram
payload is never quantized: its clean value is rounding-level, and an
int8 grid would silence the detector (``preserve=``).

The arithmetic runs in the input's own dtype (bf16 strips quantize in
bf16), the scale is the max-abs floored at 1e-12 over 127, returned as
float32, and ``torch.round`` rounds half to even: the JAX package's
dtype flow, so both packages put the same bytes on the wire.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_int8(g: torch.Tensor, axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with a max-abs scale.

    ``axis=None`` takes one scale for the whole tensor (gradients, halo
    strips); an int ``axis`` one scale per slice along it, kept as a
    size-1 dim so :func:`dequantize_int8` broadcasts (reduction rows,
    whose entries span ``||r||^2 .. ||A^2 r||^2``).  Returns the int8
    payload and the float32 scale.
    """
    mag = torch.abs(g)
    scale = (torch.amax(mag) if axis is None
             else torch.amax(mag, dim=axis, keepdim=True))
    scale = torch.clamp(scale, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`, in float32."""
    return q.to(torch.float32) * scale


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching nested dicts/lists/tuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def compress_tree(grads, error_feedback=None):
    """``(quantized tree, scales tree, new error feedback tree)``.

    Each leaf is quantized exactly once: one :func:`quantize_int8` call
    gives its (q, scale) pair.
    """
    if error_feedback is None:
        error_feedback = _tree_map(torch.zeros_like, grads)
    corrected = _tree_map(lambda g, e: g + e, grads, error_feedback)
    pairs = {}
    q = _tree_map(lambda g: pairs.setdefault(id(g), quantize_int8(g))[0],
                  corrected)
    s = _tree_map(lambda g: pairs[id(g)][1], corrected)
    recon = _tree_map(dequantize_int8, q, s)
    new_ef = _tree_map(lambda c, r: c - r, corrected, recon)
    return q, s, new_ef


def decompress_tree(q, s):
    """Dequantize a (quantized tree, scales tree) pair."""
    return _tree_map(dequantize_int8, q, s)


def compressed_grads(grads, error_feedback=None):
    """Quantize and dequantize with error feedback, as the wire would:
    returns ``(effective grads, new error feedback)``."""
    q, s, ef = compress_tree(grads, error_feedback)
    return decompress_tree(q, s), ef


# -- pipelined-solver wire ---------------------------------------------------


def compress_halo(strip: torch.Tensor,
                  error_feedback: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize one halo strip to ``(int8 payload, float32 scale,
    new error feedback)``.

    ``strip`` is the (k, 2h) edge slab a sharded body sends a chain
    neighbour each iteration.  The sender keeps the returned feedback
    (``strip``'s shape and dtype) and passes it back next iteration, so
    the quantization residual of the same rows re-enters instead of
    being lost; ``error_feedback=None`` is the no-feedback wire.
    """
    corrected = strip if error_feedback is None \
        else strip + error_feedback.to(strip.dtype)
    q, scale = quantize_int8(corrected)
    recon = dequantize_int8(q, scale).to(strip.dtype)
    return q, scale, corrected - recon


def decompress_halo(q: torch.Tensor, scale: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """Receiver side of :func:`compress_halo`; optional target dtype."""
    out = dequantize_int8(q, scale)
    return out if dtype is None else out.to(dtype)


def compress_gram(partial: torch.Tensor,
                  error_feedback: Optional[torch.Tensor] = None,
                  preserve: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize and dequantize a carried reduction payload.

    The sharded bodies carry this rank's partial reduction row one
    iteration and finish it with a split-phase all-reduce.  Squeezing it
    through the int8 grid before the issue leaves the reduction count and
    order unchanged while the summed values sit on the grid the wire
    would carry.  ``preserve`` (bool, ``partial``'s shape) marks entries
    kept exact (the ABFT checksum).  One scale per row (last axis).
    Returns ``(wire_partial, new_error_feedback)``.
    """
    zero = torch.zeros_like(partial)
    if preserve is None:
        preserve = torch.zeros(partial.shape, dtype=torch.bool,
                               device=partial.device)
    corrected = partial if error_feedback is None \
        else partial + error_feedback.to(partial.dtype)
    masked = torch.where(preserve, zero, corrected)
    q, scale = quantize_int8(masked, axis=-1)
    recon = dequantize_int8(q, scale).to(partial.dtype)
    out = torch.where(preserve, partial, recon)
    new_ef = torch.where(preserve, zero, masked - recon)
    return out, new_ef
