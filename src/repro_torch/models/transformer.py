"""The decoder LM, attention families: dense GQA and sliding-window layers.

The port of the JAX package's ``models/transformer.py`` for the block
kinds ``ATTN`` and ``ATTN_LOCAL`` (qwen3-1.7b, minitron-8b,
starcoder2-15b, command-r-plus-104b).  The layer stack is
``cfg.block_pattern`` cycled over ``cfg.num_layers``; where the reference
stacks each pattern position's parameters and scans over them, the port
keeps one module per layer in an ``nn.ModuleList`` in layer order and
loops over it in Python (``convert.lm_params_from_numpy`` unstacks the
reference's tree: scanned groups first, then the remainder layers).

Modes:
  train   — full forward (the loss comes with training)
  prefill — full forward, returns last-position logits + per-layer caches
  decode  — one token with the per-layer KV caches

State: ``{"layers": [AttnState per layer], "pos": int}``; ``pos`` is a
Python int, the host's count of the positions already in the caches.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, RECURRENT, RWKV,
                                      ModelConfig)
from repro_torch.models.attention import (Attention, attention_block,
                                          init_attention, init_attn_state)
from repro_torch.models.layers import (MLP, Linear, RMSNorm, _normal,
                                       _param, init_linear, init_mlp,
                                       init_rmsnorm, linear, mlp, rms_norm,
                                       sinusoidal_positions)

AUX_KEYS = ("moe_aux", "moe_z")
NOT_PORTED = "not ported yet (ROADMAP.md queue 1 item 8)"


class Hints:
    """Sharding hints; the default is a no-op (one device)."""

    mesh = None

    def activation(self, x):  # (B, S, d) residual stream
        return x

    def logits(self, x):
        return x

    def heads(self, x):  # (B, S, H, D) attention internals
        return x

    def kv_heads(self, x):  # (B, S, KV, D)
        return x


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the families the port lacks."""
    what = []
    if cfg.moe is not None:
        what.append("MoE FFNs")
    what += [f"{kind} blocks" for kind in sorted(set(cfg.block_pattern))
             if kind in (RECURRENT, RWKV)]
    if cfg.frontend is not None:
        what.append("modality frontends")
    if cfg.num_codebooks > 1:
        what.append("parallel codebooks")
    if what:
        raise NotImplementedError(f"{cfg.name}: {', '.join(what)} "
                                  f"{NOT_PORTED}")


class Block(nn.Module):
    """One layer: pre-norms, attention and the FFN."""

    def __init__(self, kind: str, norm1: RMSNorm, norm2: RMSNorm,
                 attn: Attention, ffn: MLP):
        super().__init__()
        self.kind = kind
        self.norm1, self.norm2 = norm1, norm2
        self.attn, self.ffn = attn, ffn


class LM(nn.Module):
    """The model's parameters: token embedding, layers in order, final
    norm and (untied) head."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: RMSNorm,
                 head: Optional[Linear] = None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.num_layers or tuple(
                b.kind for b in blocks) != cfg.layer_kinds():
            raise ValueError(f"{cfg.name}: blocks do not follow "
                             f"{cfg.layer_kinds()}")
        if (head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings="
                             f"{cfg.tie_embeddings} but head is {head}")
        self.embed = _param(embed)  # (V, d)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.head = head


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, generator, device) -> Block:
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    return Block(kind, init_rmsnorm(cfg.d_model, dt, device=device),
                 init_rmsnorm(cfg.d_model, dt, device=device),
                 init_attention(cfg, **kw),
                 init_mlp(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                          cfg.use_bias, **kw))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> LM:
    """Random parameters, drawn from ``generator`` (seed 0 if None) on
    ``device``: embeddings N(0, 0.02), projections N(0, 1/d_in), norms 1,
    biases 0, as the reference's initializers."""
    check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_size
    embed = _normal((V, d), 0.02, dt, generator, device)
    blocks = [_init_block(cfg, kind, generator, device)
              for kind in cfg.layer_kinds()]
    head = None
    if not cfg.tie_embeddings:
        head = init_linear(d, V, dt, generator=generator, device=device)
    return LM(cfg, embed, blocks, init_rmsnorm(d, dt, device=device), head)


# ---------------------------------------------------------------------------
# Per-layer state (decode / prefill)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cuda") -> Dict:
    """Zero decode state for all layers, in layer order."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    layers = []
    for kind in cfg.layer_kinds():
        eff = (min(cache_len, cfg.window)
               if (kind == ATTN_LOCAL and cfg.window) else cache_len)
        layers.append(init_attn_state(cfg, batch, eff, dtype, device))
    return {"layers": layers, "pos": 0}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _zero_aux():
    # the MoE load-balancing terms; 0 for every ported family (Python
    # floats, so a dense layer launches nothing for them)
    return {k: 0.0 for k in AUX_KEYS}


def apply_block(p: Block, cfg: ModelConfig, kind: str, x, positions, *,
                mode="train", state=None, pos=None, hints: Hints = Hints()):
    if kind not in (ATTN, ATTN_LOCAL):
        raise NotImplementedError(f"{kind} blocks {NOT_PORTED}")
    dtype = getattr(torch, cfg.dtype)
    eps = cfg.norm_eps
    h = rms_norm(p.norm1, x, eps)
    aux = _zero_aux()
    window = cfg.window if kind == ATTN_LOCAL else 0
    a_out, new_state = attention_block(
        p.attn, cfg, h, positions, dtype, mode=mode, state=state, pos=pos,
        window=window, hints=hints)
    if cfg.parallel_block:
        f_out = mlp(p.ffn, h, cfg.gated_mlp, dtype)
        return hints.activation(x + a_out + f_out), new_state, aux
    x = x + a_out
    h2 = rms_norm(p.norm2, x, eps)
    f_out = mlp(p.ffn, h2, cfg.gated_mlp, dtype)
    return hints.activation(x + f_out), new_state, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens):
    # gather the rows, then cast: the same bits as the reference's cast of
    # the whole table followed by the gather
    return params.embed[tokens].to(getattr(torch, cfg.dtype))


def unembed(params: LM, cfg: ModelConfig, x, hints: Hints = Hints()):
    dtype = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        return hints.logits(x @ params.embed.to(dtype).T)
    return hints.logits(linear(params.head, x, dtype))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward(params: LM, cfg: ModelConfig, batch, *, mode="train",
            hints: Hints = Hints()):
    """Full-sequence forward.  batch: {"tokens": (B, S)}.  Returns
    (x_final, states|None, aux)."""
    dtype = getattr(torch, cfg.dtype)
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S, d = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if cfg.num_heads and not cfg.use_rope:
        x = x + sinusoidal_positions(positions, d, dtype)[None]
    x = hints.activation(x)
    aux = _zero_aux()
    states = []
    for p in params.blocks:
        x, st, aux_i = apply_block(p, cfg, p.kind, x, positions, mode=mode,
                                   hints=hints)
        states.append(st)
        aux = {k: aux[k] + aux_i[k] for k in AUX_KEYS}
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    if mode == "prefill":
        return x, {"layers": states, "pos": S}, aux
    return x, None, aux


def prefill(params: LM, cfg: ModelConfig, batch, *, hints: Hints = Hints()):
    """Inference prefill: returns (last-position logits, decode state)."""
    x, states, _ = forward(params, cfg, batch, mode="prefill", hints=hints)
    logits = unembed(params, cfg, x[:, -1:, :], hints)
    return logits, states


def decode_step(params: LM, cfg: ModelConfig, state, token, *,
                hints: Hints = Hints()):
    """One decode step.  token (B,) integer; state from init_decode_state
    or prefill (its caches are written in place).  Returns (new_state,
    logits (B, 1, V))."""
    pos = state["pos"]
    x = embed_tokens(params, cfg, token[:, None])
    B, _, d = x.shape
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if cfg.num_heads and not cfg.use_rope:
        x = x + sinusoidal_positions(positions, d, getattr(torch, cfg.dtype)
                                     )[None]
    layers = []
    for p, st in zip(params.blocks, state["layers"]):
        x, st, _ = apply_block(p, cfg, p.kind, x, positions, mode="decode",
                               state=st, pos=pos, hints=hints)
        layers.append(st)
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    logits = unembed(params, cfg, x, hints)
    return {"layers": layers, "pos": pos + 1}, logits
