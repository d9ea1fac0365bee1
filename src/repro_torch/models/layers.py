"""Common neural-net primitives: parameter modules and the functions on them.

The port of the JAX package's ``models/layers.py``.  Parameters live in
small ``nn.Module`` s (``Linear``, ``RMSNorm``, ``MLP``) stored in
``param_dtype`` (fp32 masters by default); the functions keep the JAX
names and cast a weight to the compute ``dtype`` (bf16) at each use, as
the reference does.  Norm statistics and rotary angles run in fp32.

Parameters are made with ``requires_grad=False``, so serving records no
graph; ``launch/train.py::build_state`` switches them on for training.

``Hints``, the sharding hints every layer takes (a no-op on one device;
``distributed/sharding.py::MeshHints`` splits the compute), lives here
so that the attention, recurrent and model modules share one base.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _normal(shape, stddev, dtype, generator, device) -> torch.Tensor:
    z = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return z.mul_(stddev).to(dtype)  # in place: one fp32 copy at a time


class Hints:
    """Sharding hints; the default is a no-op (one device).

    ``tp``: the ranks that split heads, the FFN's and the RG-LRU's width
    and the vocabulary (1: none); ``state_split`` / ``model_index``: the
    blocks of a decode state's model dimension and this rank's.  With one
    rank every method below leaves its input as it is.  Port only:
    ``batch_axes``, :meth:`batch_mean`, :meth:`all_rows` and
    :meth:`own_rows`, which a sharded model's ranks need where the
    reference's GSPMD program sees the whole batch, and the primitives of
    the split compute (``distributed/sharding.py::MeshHints``)."""

    mesh = None
    batch_axes = ()
    tp = 1
    state_split = 1
    model_index = 0

    def activation(self, x):  # (B, S, d) residual stream
        return x

    def heads(self, H: int, S: int):
        """How attention over (B, S, H, D) is split: None, "heads" or
        "seq"."""
        return None

    def kv_heads(self, KV: int) -> bool:
        return False

    def logits(self, x):
        """The whole vocabulary from this rank's columns of it."""
        return x

    def block(self, owner, attr: str, dim: int):
        """``owner.attr``, its ``dim`` cut to this rank's block."""
        return getattr(owner, attr)

    def copy_in(self, t):
        return t

    def sum_out(self, t):
        return t

    def own_cols(self, x):
        return x

    def model_gather(self, x, dim: int):
        return x

    def whole_state(self, st):
        return st

    def state_block(self, st):
        return st

    def batch_mean(self, value, weight):
        """The mean over the whole batch of a 0-d mean over this rank's
        rows, which hold ``weight`` of the batch's count."""
        return value

    def all_rows(self, x):
        """Every rank's rows of ``x`` (dim 0), in batch order."""
        return x

    def own_rows(self, x):
        """This rank's rows of a whole-batch ``x``."""
        return x


class Linear(nn.Module):
    """``y = x @ w (+ b)`` with w (d_in, d_out), the JAX package's layout."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class RMSNorm(nn.Module):
    """Per-feature scale of an RMS norm."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


class MLP(nn.Module):
    """SwiGLU (gate, up, down) or GeLU (up, down) feed-forward weights."""

    def __init__(self, up: Linear, down: Linear, gate: Optional[Linear] = None):
        super().__init__()
        self.up = up
        self.down = down
        self.gate = gate


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def init_linear(d_in, d_out, dtype, use_bias=False, stddev=None, *,
                generator: torch.Generator, device="cuda") -> Linear:
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    w = _normal((d_in, d_out), stddev, dtype, generator, device)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if use_bias else None
    return Linear(w, b)


def linear(p: Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    y = x @ p.w.to(dtype)
    if p.b is not None:
        y = y + p.b.to(dtype)
    return y


def linear_part(p: Linear, x: torch.Tensor, dtype, hints, split: str
                ) -> torch.Tensor:
    """``linear`` as one rank of a tensor-parallel group computes it
    (``hints``: the model's sharding hints; with one rank each form is
    ``linear``):

    - ``"cols"``: this rank's block of w's columns and of b;
    - ``"rows"``: this rank's block of w's rows against ``x``'s matching
      columns, the products summed over the group, then all of b;
    - ``"shared"``: all of w and b, their gradients summed over the group
      (each rank uses them for its part of the work).
    """
    if split == "cols":
        y = x @ hints.block(p, "w", 1).to(dtype)
        if p.b is not None:
            y = y + hints.block(p, "b", 0).to(dtype)
        return y
    if split == "rows":
        y = hints.sum_out(x @ hints.block(p, "w", 0).to(dtype))
        return y if p.b is None else y + p.b.to(dtype)
    if split == "shared":
        y = x @ hints.copy_in(p.w).to(dtype)
        return y if p.b is None else y + hints.copy_in(p.b).to(dtype)
    raise ValueError(f"linear_part: split {split!r}")


def init_rmsnorm(d, dtype, *, device="cuda") -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float, scale=None
             ) -> torch.Tensor:
    """``scale``: the scale as the caller reads it (default ``p.scale``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (p.scale if scale is None else scale).float()).to(dt)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def _freqs(half: int, theta: float, device) -> torch.Tensor:
    i = torch.arange(half, dtype=torch.float32, device=device)
    return torch.exp(-math.log(theta) * i / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embedding.  x: (..., S, H, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = _freqs(half, theta, x.device)
    ang = positions[..., None].float() * freqs  # (S, half) or (B, S, half)
    if ang.dim() == 2:  # (S, half) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[..., None, :]  # (B?, S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Classic transformer sinusoidal embedding; positions (S,) -> (S, d)."""
    freqs = _freqs(d // 2, 10_000.0, positions.device)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(d_model, d_ff, gated, dtype, use_bias=False, *,
             generator: torch.Generator, device="cuda") -> MLP:
    kw = dict(generator=generator, device=device)
    down = init_linear(d_ff, d_model, dtype, use_bias, **kw)
    up = init_linear(d_model, d_ff, dtype, use_bias, **kw)
    gate = init_linear(d_model, d_ff, dtype, use_bias, **kw) if gated else None
    return MLP(up, down, gate)


def mlp(p: MLP, x: torch.Tensor, gated: bool, dtype, hints=None
        ) -> torch.Tensor:
    """With tensor-parallel ``hints``, each rank computes its block of the
    hidden width (``up`` / ``gate`` columns, ``down`` rows) and one sum
    over the group joins the blocks."""
    if hints is not None and hints.tp > 1:
        x = hints.copy_in(x)
        up = linear_part(p.up, x, dtype, hints, "cols")
        if gated:
            up = torch.nn.functional.silu(
                linear_part(p.gate, x, dtype, hints, "cols")) * up
        else:
            up = torch.nn.functional.gelu(up, approximate="tanh")
        return linear_part(p.down, up, dtype, hints, "rows")
    up = linear(p.up, x, dtype)
    if gated:
        h = torch.nn.functional.silu(linear(p.gate, x, dtype)) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = torch.nn.functional.gelu(up, approximate="tanh")
    return linear(p.down, h, dtype)


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  impl: str = "gather") -> torch.Tensor:
    """Mean CE over valid positions; logsumexp in fp32.  labels: integers.

    impl='gather'  — the label's logit by ``torch.gather`` on the vocab axis.
    impl='onehot'  — the label's logit by a one-hot contraction (the
        reference's TP-friendly form: GSPMD partitions it along a sharded
        vocab axis); the same value on one device.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if impl == "onehot":
        oh = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
        ll = torch.sum(lf * oh.to(lf.dtype), dim=-1)
    elif impl == "gather":
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        raise ValueError(f"cross_entropy: impl {impl!r}; expected 'gather' "
                         "or 'onehot'")
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
