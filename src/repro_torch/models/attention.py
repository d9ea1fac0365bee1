"""GQA attention: dense (short-seq), chunked flash (long-seq), decode w/ cache.

The port of the JAX package's ``models/attention.py``.

Layouts
-------
activations:  x (B, S, d_model)
q             (B, S, H, D)            H = num query heads
k, v          (B, S, KV, D)           KV = num kv heads (GQA)
KV cache      (B, S_cache, KV, D)

The grouped einsums keep q in (B, KV, G, S, D) internally so KV heads are
never materialized H times.  On CUDA tensors ``attend`` takes the
hand-written flash kernel (``kernels/ops.py::flash_mha``) when the config
asks for it, as the reference takes its Pallas kernel on a TPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.layers import (Hints, Linear, RMSNorm, init_linear,
                                       init_rmsnorm, linear, linear_part,
                                       rms_norm, rope)

NEG_INF = -1e30
DENSE_MAX_SEQ = 8192   # above this, use the chunked (flash) path
Q_CHUNK = 1024
KV_CHUNK = 1024


class Attention(nn.Module):
    """q/k/v/o projections and the optional per-head q/k norms."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 qnorm: Optional[RMSNorm] = None,
                 knorm: Optional[RMSNorm] = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.qnorm, self.knorm = qnorm, knorm


def init_attention(cfg, *, generator: torch.Generator, device="cuda"
                   ) -> Attention:
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    wq = init_linear(d, H * D, dt, cfg.use_bias, **kw)
    wk = init_linear(d, KV * D, dt, cfg.use_bias, **kw)
    wv = init_linear(d, KV * D, dt, cfg.use_bias, **kw)
    wo = init_linear(H * D, d, dt, cfg.use_bias, **kw)
    qnorm = knorm = None
    if cfg.qk_norm:
        qnorm = init_rmsnorm(D, dt, device=device)
        knorm = init_rmsnorm(D, dt, device=device)
    return Attention(wq, wk, wv, wo, qnorm, knorm)


def _qkv(p: Attention, cfg, x, positions, dtype):
    B, S, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(p.wq, x, dtype).reshape(B, S, H, D)
    k = linear(p.wk, x, dtype).reshape(B, S, KV, D)
    v = linear(p.wv, x, dtype).reshape(B, S, KV, D)
    q, k = _norm_rope(p, cfg, q, k, positions, positions)
    return q, k, v


def _norm_rope(p: Attention, cfg, q, k, qpos, kpos, read=None):
    """q and k after the per-head norms and rope.  ``read`` maps a norm's
    scale as this rank reads it (``hints.copy_in`` where the heads are
    split, so that its gradient is summed over the model line)."""
    if cfg.qk_norm:
        read = read or (lambda t: t)
        q = rms_norm(p.qnorm, q, cfg.norm_eps, read(p.qnorm.scale))
        k = rms_norm(p.knorm, k, cfg.norm_eps, read(p.knorm.scale))
    if cfg.use_rope:
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)
    return q, k


def _mask(qpos, kpos, window):
    m = qpos[:, None] >= kpos[None, :]
    if window:
        m = m & (qpos[:, None] - kpos[None, :] < window)
    return m


def _dense_attend(q, k, v, qpos, kpos, window, softcap,
                  sdtype=torch.float32):
    """q (B,S,H,D), k/v (B,Skv,KV,D) -> (B,S,H,D).

    ``sdtype`` is the dtype of the S^2 score tensors; the softmax sum
    accumulates in fp32 whatever it is."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(sdtype)
    scores = scores * torch.tensor(1.0 / math.sqrt(D), dtype=sdtype)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = _mask(qpos, kpos, window)
    neg = torch.finfo(sdtype).min / 2
    scores = torch.where(mask[None, None, None], scores, neg)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = torch.sum(p, dim=-1, keepdim=True,
                      dtype=torch.float32).to(sdtype)  # fp32 accumulation
    w = (p / torch.clamp(denom, min=1e-30)).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, S, H, D)


def _flash_attend(q, k, v, qpos, kpos, window, softcap, q_chunk=Q_CHUNK,
                  kv_chunk=KV_CHUNK, sdtype=torch.float32):
    """Double-chunked online-softmax attention in plain torch.

    Memory is O(q_chunk * kv_chunk) per (batch, head); the two loops take
    the place of the reference's two ``lax.scan`` s.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    Skv = k.shape[1]
    G = H // KV
    nq, nk = S // q_chunk, Skv // kv_chunk
    if S % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"({S}, {Skv})")
    scale = 1.0 / math.sqrt(D)
    scale_t = torch.tensor(scale, dtype=sdtype)

    qg = q.reshape(B, nq, q_chunk, KV, G, D).permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(B, nk, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, KV, D).permute(1, 0, 3, 2, 4)
    qpos_c = qpos.reshape(nq, q_chunk)
    kpos_c = kpos.reshape(nk, kv_chunk)

    outs = []
    for qi in range(nq):
        qch, qp = qg[qi], qpos_c[qi]  # (B,KV,G,Cq,D), (Cq,)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            kch, vch, kp = kc[ki], vc[ki], kpos_c[ki]
            s = (torch.einsum("bkgqd,bkcd->bkgqc", qch, kch).to(sdtype)
                 * scale_t).float()
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            msk = _mask(qp, kp, window)
            s = torch.where(msk[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p.to(qch.dtype), vch).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(qch.dtype))
    out = torch.stack(outs)  # (nq,B,KV,G,Cq,D)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, D)


def _kernel_attend(q, k, v):
    """Flash-attention kernel path: the scores never reach device memory.

    GQA kv heads are repeated to H (the kernel reads them H/KV times; a
    grouped-kv kernel is later work)."""
    from repro_torch.kernels.ops import flash_mha

    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, D)

    out = flash_mha(fold(q), fold(k), fold(v), causal=True)
    return out.reshape(B, H, S, D).transpose(1, 2)


def attend(q, k, v, qpos, kpos, window=0, softcap=0.0,
           dense_max=DENSE_MAX_SEQ, sdtype=torch.float32, use_kernel=False):
    if (use_kernel and q.is_cuda and window == 0 and softcap == 0.0
            and q.shape[1] == k.shape[1]):
        return _kernel_attend(q, k, v)
    if k.shape[1] <= dense_max:
        return _dense_attend(q, k, v, qpos, kpos, window, softcap,
                             sdtype=sdtype)
    return _flash_attend(q, k, v, qpos, kpos, window, softcap,
                         q_chunk=min(Q_CHUNK, q.shape[1]),
                         kv_chunk=min(KV_CHUNK, k.shape[1]), sdtype=sdtype)


class AttnState(NamedTuple):
    """Decode-time KV cache for one attention layer."""

    k: torch.Tensor  # (B, S_cache, KV, D)
    v: torch.Tensor  # (B, S_cache, KV, D)


def init_attn_state(cfg, batch, cache_len, dtype, device="cuda") -> AttnState:
    KV, D = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, cache_len, KV, D)
    return AttnState(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def decode_cache(t, pos: int, cache_len: int, window: int = 0):
    """A decode cache (B, S_c, KV, D) holding a prefill's k or v (B, pos,
    KV, D): a local layer whose ``window`` the cache reaches gets a ring
    of ``window`` slots (``init_decode_state``'s layout: position p in
    slot p % window, the last ``window`` positions kept), any other layer
    ``cache_len`` slots, zero past ``pos``."""
    B, S, KV, D = t.shape
    ring = bool(window) and cache_len >= window
    size = window if ring else cache_len
    out = t.new_zeros((B, size, KV, D))
    keep = torch.arange(max(0, S - size), S, device=t.device)
    out[:, keep % size if ring else keep] = t[:, keep]
    return out


def _split_heads(p: Attention, cfg, x, positions, dtype, split, hints):
    """q, k, v as this rank of a model line computes them under a split
    of the heads ("heads") or of q's rows ("seq"), the positions of q's
    rows, and the prefill's cache: this rank's KV heads where they split,
    else all of them.  ``x`` enters through ``hints.copy_in``: every
    rank's part of its gradient is summed."""
    B, S, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = hints.copy_in(x)
    qpos, sel = positions, None
    if split == "seq":
        # every head on q's own rows, k and v whole: each rank uses the
        # whole weights for a part of the rows
        q = linear_part(p.wq, x, dtype, hints, "shared").reshape(B, S, H, D)
        n = S // hints.tp
        lo = hints.model_index * n
        q, qpos = q[:, lo:lo + n], positions[lo:lo + n]
        kv_split = "shared"
    else:
        Hl = H // hints.tp
        q = linear_part(p.wq, x, dtype, hints, "cols").reshape(B, S, Hl, D)
        kv_split = "cols" if hints.kv_heads(KV) else "shared"
        if kv_split == "shared":
            # k and v whole; this rank's q heads read these KV heads
            G, h0 = H // KV, hints.model_index * Hl
            if Hl % G and G % Hl:
                raise ValueError(f"{Hl} heads a rank do not group over "
                                 f"{KV} KV heads")
            sel = torch.arange(h0 // G, h0 // G + max(1, Hl // G),
                               device=x.device)
    k, v = (linear_part(w, x, dtype, hints, kv_split).reshape(B, S, -1, D)
            for w in (p.wk, p.wv))
    q, k = _norm_rope(p, cfg, q, k, qpos, positions, hints.copy_in)
    cache = AttnState(k=k, v=v)
    if sel is not None:
        k, v = k[:, :, sel], v[:, :, sel]
    return q, k, v, qpos, cache


def _decode_scores(q, k, cfg, kpos, pos: int, window: int, rolling: bool):
    """The decode query q (B, 1, H, D) against cache keys k (B, S, KV, D)
    at global positions ``kpos``: fp32 scores (B, KV, G, 1, S), the
    reference's preferred_element_type=float32, softcapped, NEG_INF where
    a slot holds no position the query sees, and that validity mask."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, 1, D)
    s = torch.einsum("bkgqd,bskd->bkgqs", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if cfg.attn_logit_softcap:
        s = torch.tanh(s / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
    # a ring buffer's slots all hold one of the last ``window`` positions
    # once full; before it wraps, slots past pos are unwritten
    valid = kpos <= pos
    if window and not rolling:
        valid = valid & (kpos > pos - window)
    valid = valid[None, None, None, None]
    return torch.where(valid, s, NEG_INF), valid


def _decode_combine(s, valid, v, dtype, hints):
    """Decode attention over a cache whose sequence this rank holds a
    block of (STATE_RULES), from this block's scores ``s`` and values
    ``v``: its max, sum and weighted values in fp32, one gather of them
    over ``model``, and the softmax over the whole cache combined from
    them in rank order.  (B, 1, H * D)."""
    B, KV, G = s.shape[:3]
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    part = torch.cat([m, e.sum(-1, keepdim=True), torch.einsum(
        "bkgqs,bskd->bkgqd", e, v.float())], dim=-1)
    parts = hints.model_gather(part[None], 0)     # (splits, B, KV, G, 1, .)
    top = parts[..., :1].amax(dim=0)
    scale = torch.exp(parts[..., :1] - top)
    total = (parts[..., 1:] * scale).sum(dim=0)
    out = total[..., 1:] / total[..., :1]
    return out.to(dtype).permute(0, 3, 1, 2, 4).reshape(B, 1, -1)


def attention_block(p: Attention, cfg, x, positions, dtype, *, mode="train",
                    state: Optional[AttnState] = None, pos=None, window=0,
                    hints=None):
    """Run one attention layer.

    mode:
      train   -> full self attention over x; returns (out, None)
      prefill -> same, but also returns the cache (k, v): this rank's KV
                 heads where they are split
      decode  -> x is (B, 1, d); writes k, v into the cache at ``pos`` (a
                 Python int) IN PLACE, where the reference returns an
                 updated copy: a full-size cache is not copied per token.
                 Where the cache's sequence is split over ``model``, the
                 rank that owns the slot writes it.

    With ``cfg.shard_attn_heads`` and tensor-parallel ``hints`` (the
    reference's ``hints.heads`` / ``kv_heads``), train and prefill split
    the heads, or q's rows when H does not divide; ``wo`` takes this
    rank's rows and one sum over the model line joins them.  Decode
    computes q, k and v from the weights' column blocks (gathered as
    activations) and its ``wo`` rows the same way.
    """
    hints = hints if hints is not None else Hints()
    B = x.shape[0]
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if mode in ("train", "prefill"):
        split = (hints.heads(H, x.shape[1]) if cfg.shard_attn_heads
                 else None)
        kw = dict(window=window, softcap=cfg.attn_logit_softcap,
                  dense_max=cfg.dense_attn_max_seq,
                  sdtype=getattr(torch, cfg.scores_dtype),
                  use_kernel=cfg.attn_kernel)
        new_state = None
        if split is None:
            q, k, v = _qkv(p, cfg, x, positions, dtype)
            out = attend(q, k, v, positions, positions, **kw)
            out = linear(p.wo, out.reshape(B, -1, H * D), dtype)
        else:
            q, k, v, qpos, kept = _split_heads(p, cfg, x, positions, dtype,
                                               split, hints)
            out = attend(q, k, v, qpos, positions, **kw)
            out = out.reshape(B, q.shape[1], -1)
            if split == "seq":
                out = hints.whole_seq(linear_part(p.wo, out, dtype, hints,
                                                  "shared"))
            else:
                out = linear_part(p.wo, out, dtype, hints, "rows")
        if mode == "prefill":
            new_state = AttnState(k=k, v=v) if split is None else kept
        return out, new_state

    if state is None or pos is None:
        raise ValueError("decode needs the layer's state and pos")
    if hints.tp > 1:
        # this rank's columns of q, k and v, gathered as activations in
        # one collective
        cols = [linear_part(w, x, dtype, hints, "cols")
                for w in (p.wq, p.wk, p.wv)]
        every = hints.model_gather(torch.cat(cols, -1)[None], 0)
        q, k, v = (t.movedim(0, -2).reshape(B, 1, n, D) for t, n in zip(
            every.split([c.shape[-1] for c in cols], -1), (H, KV, KV)))
        q, k = _norm_rope(p, cfg, q, k, positions, positions)
    else:
        q, k, v = _qkv(p, cfg, x, positions, dtype)  # S == 1
    S_l = state.k.shape[1]
    S_cache = S_l * hints.state_split
    rolling = bool(window) and S_cache == window  # ring buffer (local attn)
    if not rolling and pos >= S_cache:
        raise ValueError(f"decode at position {pos} past a cache of "
                         f"{S_cache}")
    lo = hints.model_index * S_l        # this rank's block of the slots
    slot = (pos % S_cache if rolling else pos) - lo
    if 0 <= slot < S_l:
        state.k[:, slot] = k[:, 0]
        state.v[:, slot] = v[:, 0]
    kpos = lo + torch.arange(S_l, device=x.device)
    s, valid = _decode_scores(q, state.k, cfg, kpos, pos, window, rolling)
    if hints.state_split > 1:
        out = _decode_combine(s, valid, state.v, dtype, hints)
    else:
        w = torch.softmax(s, dim=-1).to(dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, state.v).reshape(
            B, 1, H * D)
    out = linear_part(p.wo, hints.own_cols(out), dtype, hints, "rows")
    return out, state
