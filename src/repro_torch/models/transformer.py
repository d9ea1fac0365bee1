"""The unified decoder LM covering all ten configs of ``configs/registry``.

The port of the JAX package's ``models/transformer.py``: dense GQA and
sliding-window attention layers, MoE FFNs (with the arctic-style dense
residual beside them), RG-LRU and RWKV-6 recurrent layers, modality
frontends and parallel codebooks.  The layer stack is
``cfg.block_pattern`` cycled over ``cfg.num_layers``; where the reference
stacks each pattern position's parameters and scans over them, the port
keeps one module per layer in an ``nn.ModuleList`` in layer order and
loops over it in Python (``convert.lm_params_from_numpy`` unstacks the
reference's tree: scanned groups first, then the remainder layers).

Modes:
  train   — full forward; ``loss_fn`` puts the loss on it, and ``remat``
            recomputes each layer in the backward pass
            (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)
  prefill — full forward, returns last-position logits + per-layer states
  decode  — one token with the per-layer states

Modality frontends (pixtral patches, musicgen frames) are stubs, as in
the reference: precomputed (B, F, d) embeddings occupy the first F
positions.  Codebook configs (musicgen) take tokens (B, S, ncb), sum the
codebooks' embeddings and return a tuple of logits, one per codebook.

State: ``{"layers": [per-layer state], "pos": int}``, a layer's state an
``AttnState`` (KV cache), ``RGLRUState`` or ``RWKVState``; ``pos`` is a
Python int, the host's count of the positions already seen (frontend
positions included).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, RECURRENT, RWKV,
                                      ModelConfig)
from repro_torch.models.attention import (Attention, attention_block,
                                          init_attention, init_attn_state)
from repro_torch.models.layers import (MLP, Hints, Linear, RMSNorm,
                                       _normal, _param, cross_entropy,
                                       init_linear, init_mlp, init_rmsnorm,
                                       linear_part, mlp, rms_norm,
                                       sinusoidal_positions)
from repro_torch.models.moe import MoE, init_moe, moe_ffn
from repro_torch.models.recurrent import (RGLRU, RWKV as RWKVParams,
                                          RGLRUState, RWKVState, init_rglru,
                                          init_rwkv, rglru_block,
                                          rwkv_channel_mix, rwkv_time_mix)

#: the MoE loss terms (``loss_fn`` weighs them) and, port only, the count
#: of (token, expert) assignments dropped at capacity; each summed over
#: layers
AUX_KEYS = ("moe_aux", "moe_z", "moe_dropped")
MOE_AUX_COEF = 0.01
MOE_Z_COEF = 1e-3


class Block(nn.Module):
    """One layer: pre-norms, the mixer (``attn``, ``rec`` or ``tm``) and
    the FFN (``ffn`` dense, ``moe``, or both for a dense residual; a RWKV
    layer's channel-mix lives in ``tm``)."""

    def __init__(self, kind: str, norm1: RMSNorm, norm2: RMSNorm, *,
                 attn: Optional[Attention] = None,
                 rec: Optional[RGLRU] = None,
                 tm: Optional[RWKVParams] = None,
                 ffn: Optional[MLP] = None, moe: Optional[MoE] = None):
        super().__init__()
        want = {ATTN: "attn", ATTN_LOCAL: "attn", RECURRENT: "rec",
                RWKV: "tm"}[kind]
        mixers = {"attn": attn, "rec": rec, "tm": tm}
        if mixers[want] is None or any(v is not None for k, v in
                                       mixers.items() if k != want):
            raise ValueError(f"a {kind} block takes {want} alone")
        self.kind = kind
        self.norm1, self.norm2 = norm1, norm2
        self.attn, self.rec, self.tm = attn, rec, tm
        self.ffn, self.moe = ffn, moe


class LM(nn.Module):
    """The model's parameters: token embedding(s), layers in order, final
    norm and (untied) head(s).  With codebooks ``embed`` is a
    ``ParameterList`` and ``head`` a ``ModuleList``, one per codebook."""

    def __init__(self, cfg: ModelConfig,
                 embed: Union[torch.Tensor, Sequence[torch.Tensor]],
                 blocks: List[Block], final_norm: RMSNorm,
                 head: Union[None, Linear, Sequence[Linear]] = None):
        super().__init__()
        if len(blocks) != cfg.num_layers or tuple(
                b.kind for b in blocks) != cfg.layer_kinds():
            raise ValueError(f"{cfg.name}: blocks do not follow "
                             f"{cfg.layer_kinds()}")
        for b in blocks:
            want_moe = cfg.moe is not None and b.kind != RWKV
            want_ffn = b.kind != RWKV and (
                cfg.moe is None or cfg.moe.dense_residual)
            if (b.moe is not None) != want_moe or \
                    (b.ffn is not None) != want_ffn:
                raise ValueError(f"{cfg.name}: a {b.kind} block's FFN "
                                 "does not follow the config")
        if (head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings="
                             f"{cfg.tie_embeddings} but head is {head}")
        ncb = cfg.num_codebooks
        if ncb > 1:
            if len(embed) != ncb or (head is not None and len(head) != ncb):
                raise ValueError(f"{cfg.name}: {ncb} codebooks need as many "
                                 "embeddings and heads")
            self.embed = nn.ParameterList([_param(e) for e in embed])
            self.head = None if head is None else nn.ModuleList(head)
        else:
            self.embed = _param(embed)  # (V, d)
            self.head = head
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, generator, device) -> Block:
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    norms = (init_rmsnorm(cfg.d_model, dt, device=device),
             init_rmsnorm(cfg.d_model, dt, device=device))
    if kind == RWKV:  # channel-mix lives inside 'tm' (cm_*)
        return Block(kind, *norms, tm=init_rwkv(cfg, **kw))
    mixer = ({"rec": init_rglru(cfg, **kw)} if kind == RECURRENT
             else {"attn": init_attention(cfg, **kw)})
    moe = init_moe(cfg, **kw) if cfg.moe is not None else None
    ffn = None
    if cfg.moe is None or cfg.moe.dense_residual:
        ffn = init_mlp(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dt,
                       cfg.use_bias, **kw)
    return Block(kind, *norms, ffn=ffn, moe=moe, **mixer)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", place=None) -> LM:
    """Random parameters, drawn from ``generator`` (seed 0 if None) on
    ``device`` with the reference's initializers: embeddings N(0, 0.02),
    projections and experts N(0, 1/d_in), the recurrent blocks' own
    (``init_rglru``, ``init_rwkv``), norms 1, biases 0.  ``place(name,
    block)``, when given, is called on each layer right after its draws
    (``distributed/sharding.py::init_sharded_params`` keeps its blocks)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.param_dtype)
    d, V, ncb = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    embeds = [_normal((V, d), 0.02, dt, generator, device)
              for _ in range(ncb)]
    blocks = []
    for i, kind in enumerate(cfg.layer_kinds()):
        blocks.append(_init_block(cfg, kind, generator, device))
        if place is not None:
            place(f"blocks.{i}", blocks[-1])
    heads = None
    if not cfg.tie_embeddings:
        heads = [init_linear(d, V, dt, generator=generator, device=device)
                 for _ in range(ncb)]
    if ncb == 1:
        embeds = embeds[0]
        heads = None if heads is None else heads[0]
    return LM(cfg, embeds, blocks, init_rmsnorm(d, dt, device=device), heads)


# ---------------------------------------------------------------------------
# Per-layer state (decode / prefill)
# ---------------------------------------------------------------------------

def _init_block_state(cfg: ModelConfig, kind: str, batch: int,
                      cache_len: int, dtype, device):
    if kind in (ATTN, ATTN_LOCAL):
        eff = (min(cache_len, cfg.window)
               if (kind == ATTN_LOCAL and cfg.window) else cache_len)
        return init_attn_state(cfg, batch, eff, dtype, device)
    if kind == RECURRENT:
        w = cfg.lru_width or cfg.d_model
        return RGLRUState(
            h=torch.zeros((batch, w), dtype=torch.float32, device=device),
            conv=torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                             device=device))
    if kind == RWKV:
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd
        return RWKVState(
            s=torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                          device=device),
            tm_last=torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
            cm_last=torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device))
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device="cuda") -> Dict:
    """Zero decode state for all layers, in layer order."""
    dtype = getattr(torch, cfg.dtype)
    return {"layers": [_init_block_state(cfg, kind, batch, cache_len, dtype,
                                         device)
                       for kind in cfg.layer_kinds()],
            "pos": 0}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _zero_aux():
    # Python zeros, so a layer without experts launches nothing for them
    return {k: 0 for k in AUX_KEYS}


def _ffn_part(p: Block, cfg: ModelConfig, h, dtype, hints: Hints = Hints()):
    # with a mesh, moe_impl="ep" takes the expert-parallel route; the
    # gather route dispatches the whole batch on every rank and keeps its
    # own rows, which is what the reference's GSPMD program computes
    if cfg.moe is not None:
        if cfg.moe_impl == "ep" and hints.mesh is not None:
            from repro_torch.models.moe_ep import moe_ffn_ep
            out, aux = moe_ffn_ep(p.moe, cfg, h, dtype, hints.mesh,
                                  hints.batch_axes)
        else:
            out, aux = moe_ffn(p.moe, cfg, hints.all_rows(h), dtype)
            out = hints.own_rows(out)
            # every rank of the batch computed the same terms: the mean
            # of the copies, so that the gradient counts them once
            aux = dict(aux, moe_aux=hints.batch_mean(aux["moe_aux"], 1.0),
                       moe_z=hints.batch_mean(aux["moe_z"], 1.0))
        if cfg.moe.dense_residual:
            out = out + mlp(p.ffn, h, cfg.gated_mlp, dtype, hints)
        return out, aux
    return mlp(p.ffn, h, cfg.gated_mlp, dtype, hints), _zero_aux()


def attn_out(p: Block, cfg: ModelConfig, kind: str, x, positions, *,
             hints: Hints = Hints()):
    """A train-mode attention layer's attention output (after ``wo``),
    the tensor ``cfg.save_attn_out`` keeps through a remat."""
    window = cfg.window if kind == ATTN_LOCAL else 0
    h = rms_norm(p.norm1, x, cfg.norm_eps)
    return attention_block(p.attn, cfg, h, positions,
                           getattr(torch, cfg.dtype), window=window,
                           hints=hints)[0]


def apply_block(p: Block, cfg: ModelConfig, kind: str, x, positions, *,
                mode="train", state=None, pos=None, hints: Hints = Hints(),
                a_out=None):
    """One layer.  ``a_out``: an attention layer's :func:`attn_out`, when
    the caller computed it (train mode)."""
    dtype = getattr(torch, cfg.dtype)
    eps = cfg.norm_eps
    h = rms_norm(p.norm1, x, eps)

    if kind in (ATTN, ATTN_LOCAL):
        window = cfg.window if kind == ATTN_LOCAL else 0
        new_state = None
        if a_out is None:
            a_out, new_state = attention_block(
                p.attn, cfg, h, positions, dtype, mode=mode, state=state,
                pos=pos, window=window, hints=hints)
        if cfg.parallel_block:
            f_out, aux = _ffn_part(p, cfg, h, dtype, hints)
            return hints.activation(x + a_out + f_out), new_state, aux
        x = x + a_out
        h2 = rms_norm(p.norm2, x, eps)
        f_out, aux = _ffn_part(p, cfg, h2, dtype, hints)
        return hints.activation(x + f_out), new_state, aux

    if kind == RECURRENT:
        if hints.tp > 1:        # the width split: the state's own blocks
            r_out, new_state = rglru_block(p.rec, cfg, h, dtype, mode=mode,
                                           state=state, hints=hints)
        else:
            # a decode state stored as blocks, whole at use and this
            # rank's blocks after (a prefill's state stays whole:
            # ``sharding.decode_state`` places it)
            r_out, new_state = rglru_block(
                p.rec, cfg, h, dtype, mode=mode,
                state=None if state is None else hints.whole_state(state))
            if mode == "decode":
                new_state = hints.state_block(new_state)
        x = x + r_out
        h2 = rms_norm(p.norm2, x, eps)
        f_out, aux = _ffn_part(p, cfg, h2, dtype, hints)
        return hints.activation(x + f_out), new_state, aux

    if kind == RWKV:
        if state is not None:
            state = hints.whole_state(state)
        tm_out, tm_state = rwkv_time_mix(p.tm, cfg, h, dtype, mode=mode,
                                         state=state)
        x = x + tm_out
        h2 = rms_norm(p.norm2, x, eps)
        cm_last = state.cm_last if state is not None else None
        cm_out, new_cm_last = rwkv_channel_mix(p.tm, cfg, h2, dtype,
                                               mode=mode, last=cm_last)
        new_state = None
        if mode != "train":
            new_state = RWKVState(s=tm_state.s, tm_last=tm_state.tm_last,
                                  cm_last=new_cm_last)
            if mode == "decode":
                new_state = hints.state_block(new_state)
        return hints.activation(x + cm_out), new_state, _zero_aux()

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens,
                 hints: Hints = Hints()):
    # gather the rows, then cast: the same bits as the reference's cast of
    # the whole table followed by the gather; codebooks summed in order.
    # Split over the vocabulary (tensor-parallel hints), each rank looks up
    # the tokens of its rows of the table and one sum over the model line
    # joins them (one row and zeros: exact)
    dtype = getattr(torch, cfg.dtype)

    def rows(owner, attr, tok):
        if hints.tp == 1:
            return getattr(owner, attr)[tok].to(dtype)
        table = hints.block(owner, attr, 0)
        n = table.shape[0]
        local = tok - hints.model_index * n
        mine = (local >= 0) & (local < n)
        got = table[torch.where(mine, local, 0)]
        return hints.sum_out(torch.where(mine[..., None], got, 0.0)
                             ).to(dtype)

    if cfg.num_codebooks > 1:
        return sum(rows(params.embed, str(i), tokens[..., i])
                   for i in range(cfg.num_codebooks))
    return rows(params, "embed", tokens)


def unembed(params: LM, cfg: ModelConfig, x, hints: Hints = Hints()):
    """Logits (B, S, V); a tuple of them, one per codebook.  With
    tensor-parallel ``hints`` each rank computes its block of the
    vocabulary and :meth:`Hints.logits` gathers it."""
    dtype = getattr(torch, cfg.dtype)
    x = hints.copy_in(x)

    def tied(owner, attr):
        return hints.logits(x @ hints.block(owner, attr, 0).to(dtype).T)

    def head(h):
        return hints.logits(linear_part(h, x, dtype, hints, "cols"))

    if cfg.num_codebooks > 1:
        if cfg.tie_embeddings:
            return tuple(tied(params.embed, str(i))
                         for i in range(cfg.num_codebooks))
        return tuple(head(h) for h in params.head)
    if cfg.tie_embeddings:
        return tied(params, "embed")
    return head(params.head)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _train_block(p: Block, cfg: ModelConfig, x, positions, remat: str,
                 hints: Hints):
    """A train-mode layer under the remat policy.

    "none" saves every activation for the backward pass; "full" keeps only
    the layer's input and recomputes the rest (``jax.checkpoint`` with
    ``nothing_saveable``).  With ``cfg.save_attn_out`` an attention layer
    runs as two checkpointed segments, x -> attention output and
    (x, attention output) -> the layer's output, so the attention output
    is kept and the backward pass recomputes the attention for its own
    gradient only (the reference's ``save_only_these_names("attn_out")``).
    """
    if remat == "none":
        return apply_block(p, cfg, p.kind, x, positions, hints=hints)
    if remat != "full":
        raise ValueError(f"remat {remat!r}; expected 'none' or 'full'")
    if cfg.save_attn_out and p.kind in (ATTN, ATTN_LOCAL):
        a = checkpoint(attn_out, p, cfg, p.kind, x, positions, hints=hints,
                       use_reentrant=False)
        return checkpoint(apply_block, p, cfg, p.kind, x, positions,
                          hints=hints, a_out=a, use_reentrant=False)
    return checkpoint(apply_block, p, cfg, p.kind, x, positions, hints=hints,
                      use_reentrant=False)


def forward(params: LM, cfg: ModelConfig, batch, *, mode="train",
            remat="full", hints: Hints = Hints()):
    """Full-sequence forward.  batch: tokens (B, S_tok[, ncb]), and
    'frontend' (B, F, d) when the config has one.  Returns (x_final,
    states|None, aux).

    ``remat`` ("full" or "none") applies to train mode under autograd
    (:func:`_train_block`); prefill and a forward without a graph keep no
    checkpoint."""
    dtype = getattr(torch, cfg.dtype)
    x = embed_tokens(params, cfg, batch["tokens"], hints)
    if cfg.frontend is not None:
        x = torch.cat([batch["frontend"].to(dtype), x], dim=1)
    B, S, d = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if cfg.num_heads and not cfg.use_rope:
        x = x + sinusoidal_positions(positions, d, dtype)[None]
    x = hints.activation(x)
    aux = _zero_aux()
    states = []
    train = mode == "train" and torch.is_grad_enabled()
    for p in params.blocks:
        if train:
            x, st, aux_i = _train_block(p, cfg, x, positions, remat, hints)
        else:
            x, st, aux_i = apply_block(p, cfg, p.kind, x, positions,
                                       mode=mode, hints=hints)
        states.append(st)
        aux = {k: aux[k] + aux_i[k] for k in AUX_KEYS}
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    if mode == "prefill":
        return x, {"layers": states, "pos": S}, aux
    return x, None, aux


def loss_fn(params: LM, cfg: ModelConfig, batch, *, remat="full",
            hints: Hints = Hints()):
    """Training loss.  labels (B, S_tok[, ncb]); optional 'mask' (B, S_tok).

    Returns (total, metrics): total = CE (the mean over codebooks) +
    MOE_AUX_COEF * moe_aux + MOE_Z_COEF * moe_z; metrics carry ``ce`` and
    the aux sums, ``moe_dropped`` (port only) among them, outside the loss.
    """
    x, _, aux = forward(params, cfg, batch, mode="train", remat=remat,
                        hints=hints)
    F = cfg.frontend.num_positions if cfg.frontend is not None else 0
    x_tok = x[:, F:, :]
    labels = batch["labels"]
    mask = batch.get("mask")
    logits = unembed(params, cfg, x_tok, hints)
    if cfg.num_codebooks > 1:
        ce = sum(cross_entropy(logits[i], labels[..., i], mask, cfg.ce_impl)
                 for i in range(cfg.num_codebooks)) / cfg.num_codebooks
    else:
        ce = cross_entropy(logits, labels, mask, cfg.ce_impl)
    count = (mask.float().sum() if mask is not None
             else float(labels.shape[0] * labels.shape[1]))
    ce = hints.batch_mean(ce, count)
    total = ce + MOE_AUX_COEF * aux["moe_aux"] + MOE_Z_COEF * aux["moe_z"]
    return total, {"ce": ce, **aux}


def prefill(params: LM, cfg: ModelConfig, batch, *, hints: Hints = Hints()):
    """Inference prefill: returns (last-position logits, decode state)."""
    x, states, _ = forward(params, cfg, batch, mode="prefill", remat="none",
                           hints=hints)
    logits = unembed(params, cfg, x[:, -1:, :], hints)
    return logits, states


def decode_step(params: LM, cfg: ModelConfig, state, token, *,
                hints: Hints = Hints()):
    """One decode step.  token (B,[ncb]) integer; state from
    init_decode_state or prefill (its KV caches are written in place).
    Returns (new_state, logits (B, 1, V), a tuple of them with codebooks)."""
    pos = state["pos"]
    tok = token[:, None] if cfg.num_codebooks == 1 else token[:, None, :]
    x = embed_tokens(params, cfg, tok, hints)
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
