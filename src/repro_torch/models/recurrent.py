"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and RWKV-6 (Finch).

The port of the JAX package's ``models/recurrent.py``.  Both are
sub-quadratic: O(S) time, O(1) state.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a u_t);  i_t = sigmoid(W_i u_t)
    a_t = exp(c * softplus(Lambda) * (-r_t))        in (0, 1)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)
computed with a parallel prefix scan over the sequence: where the
reference calls ``jax.lax.associative_scan``, the port doubles the span
log2(S) times with the same combine ``(a1 a2, a2 b1 + b2)``.

RWKV-6 time-mix (per head, Dk x Dv state S):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent per-channel decay w_t = exp(-exp(w0 + tanh(x W_A) W_B)).
Computed in chunks, as the reference does: intra-chunk pairwise (exact,
every exponent <= 0) plus the carried state between chunks.  The model's
block runs this chunked form in torch; the CUDA kernel
``kernels/wkv.py::wkv_recurrent`` takes no initial state and returns no
last one, and chip_smoke.py holds the two together from a zero state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (Linear, _normal, _param, init_linear,
                                       linear, linear_part)

RWKV_CHUNK = 64
RGLRU_C = 8.0
DECAY_LORA = 64


# ===========================================================================
# RG-LRU block
# ===========================================================================

class RGLRUState(NamedTuple):
    h: torch.Tensor     # (B, W) recurrent state, fp32
    conv: torch.Tensor  # (B, conv_width - 1, W) temporal-conv tail


class RGLRU(nn.Module):
    """In-projections, depthwise conv (K, W), the gates, Lambda (the
    reference's ``lambda``) and the out-projection."""

    def __init__(self, in_x: Linear, in_gate: Linear, conv_w: torch.Tensor,
                 gate_a: Linear, gate_i: Linear, lam: torch.Tensor,
                 out: Linear):
        super().__init__()
        self.in_x, self.in_gate = in_x, in_gate
        self.conv_w = _param(conv_w)
        self.gate_a, self.gate_i = gate_a, gate_i
        self.lam = _param(lam)
        self.out = out


def init_rglru(cfg, *, generator: torch.Generator, device="cuda") -> RGLRU:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    in_x = init_linear(d, w, dt, cfg.use_bias, **kw)
    in_gate = init_linear(d, w, dt, cfg.use_bias, **kw)
    conv_w = _normal((cfg.conv1d_width, w), 0.1, dt, generator, device)
    gate_a = init_linear(w, w, dt, **kw)
    gate_i = init_linear(w, w, dt, **kw)
    # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (Griffin appendix)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = lo + (hi - lo) * torch.rand((w,), generator=generator,
                                    device=device, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))  # softplus^-1
    out = init_linear(w, d, dt, cfg.use_bias, **kw)
    return RGLRU(in_x, in_gate, conv_w, gate_a, gate_i, lam.to(dt), out)


def _causal_conv1d(u, conv_w, tail=None):
    """u (B,S,W), conv_w (K,W); causal depthwise conv via shifted adds.

    tail (B,K-1,W) carries the last K-1 inputs of the previous segment
    (decode / a second segment)."""
    K = conv_w.shape[0]
    B, S, W = u.shape
    if tail is None:
        tail = u.new_zeros((B, K - 1, W))
    ext = torch.cat([tail, u], dim=1)  # (B, S+K-1, W)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + ext[:, i:i + S, :] * conv_w[K - 1 - i][None, None, :]
    new_tail = ext[:, S:, :]  # the last K-1 inputs
    return out, new_tail


def _rglru_scan(u, a, h0):
    """h_t = a_t h_{t-1} + b_t with b = sqrt(1-a^2) * u; a prefix scan.

    u, a: (B, S, W) fp32;  h0: (B, W) fp32.  Returns h (B,S,W), h_last.
    Pass j combines each position with the one 2^j before it (Hillis-
    Steele): after ceil(log2 S) passes position t holds the product of
    a_0..a_t and h_t."""
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * u
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return b, b[:, -1, :]


def rglru_block(p: RGLRU, cfg, x, dtype, *, mode="train",
                state: Optional[RGLRUState] = None, hints=None):
    """Griffin recurrent block: (in-proj -> conv -> RG-LRU) * gelu-gate ->
    out.  Returns (out, RGLRUState | None).

    With tensor-parallel ``hints`` each rank of a model line runs its
    block of the width (STATE_RULES' split of ``h`` and ``conv``): its
    columns of ``in_x`` / ``in_gate`` / ``conv_w`` / Lambda, the gates'
    rows against its width (summed over the line, then its columns kept)
    and ``out``'s rows (summed).  A decode state is then this rank's
    blocks in and out; a prefill's is gathered whole."""
    B, S, _ = x.shape
    tp = hints is not None and hints.tp > 1
    if tp:
        x = hints.copy_in(x)

    def cols(lin):
        return linear_part(lin, x, dtype, hints, "cols") if tp \
            else linear(lin, x, dtype)

    def gate_of(lin, t):
        if not tp:
            return linear(lin, t, dtype)
        return hints.own_cols(linear_part(lin, t, dtype, hints, "rows"))

    gate = F.gelu(cols(p.in_gate), approximate="tanh")
    u = cols(p.in_x)
    w = u.shape[-1]

    tail = state.conv if state is not None else None
    conv_w = hints.block(p, "conv_w", 1) if tp else p.conv_w
    u, new_tail = _causal_conv1d(u, conv_w.to(dtype), tail)

    uf = u.float()
    r = torch.sigmoid(gate_of(p.gate_a, u).float())
    i = torch.sigmoid(gate_of(p.gate_i, u).float())
    lam = hints.block(p, "lam", 0) if tp else p.lam
    log_a = -RGLRU_C * F.softplus(lam.float()) * r  # <= 0
    a = torch.exp(log_a)

    h0 = (state.h if state is not None
          else torch.zeros((B, w), dtype=torch.float32, device=x.device))
    if mode == "decode":  # S == 1: the exact single step
        b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * (i * uf)
        h = a[:, 0] * h0 + b[:, 0]
        hh = h[:, None, :]
        h_last = h
    else:
        hh, h_last = _rglru_scan(i * uf, a, h0)

    y = hh.to(dtype) * gate
    if not tp:
        out = linear(p.out, y, dtype)
    else:
        out = linear_part(p.out, y, dtype, hints, "rows")
        if mode == "prefill":
            h_last, new_tail = (hints.model_gather(t, t.dim() - 1)
                                for t in (h_last, new_tail))
    new_state = RGLRUState(h=h_last, conv=new_tail) if mode != "train" \
        else None
    return out, new_state


# ===========================================================================
# RWKV-6 block (time-mix + channel-mix)
# ===========================================================================

class RWKVState(NamedTuple):
    s: torch.Tensor        # (B, H, Dk, Dv) wkv state, fp32
    tm_last: torch.Tensor  # (B, d) last token input of time-mix (shift)
    cm_last: torch.Tensor  # (B, d) last token input of channel-mix


class RWKV(nn.Module):
    """Time-mix weights and, as in the reference, the channel-mix's
    (``cm_*``): a RWKV layer has no separate FFN."""

    def __init__(self, mu, wr: Linear, wk: Linear, wv: Linear, wg: Linear,
                 wo: Linear, w0, decay_a: Linear, decay_b: Linear, u, ln_x,
                 cm_mu, cm_k: Linear, cm_v: Linear, cm_r: Linear):
        super().__init__()
        self.mu = _param(mu)            # (5, d): r, k, v, g, w shift mixes
        self.wr, self.wk, self.wv, self.wg, self.wo = wr, wk, wv, wg, wo
        self.w0 = _param(w0)            # (d,)
        self.decay_a, self.decay_b = decay_a, decay_b
        self.u = _param(u)              # (H, D) current-token bonus
        self.ln_x = _param(ln_x)        # (d,) group-norm scale
        self.cm_mu = _param(cm_mu)      # (2, d)
        self.cm_k, self.cm_v, self.cm_r = cm_k, cm_v, cm_r


def init_rwkv(cfg, *, generator: torch.Generator, device="cuda") -> RWKV:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32,
                          device=device).to(dt)

    return RWKV(
        mu=full((5, d), 0.5),
        wr=init_linear(d, d, dt, **kw), wk=init_linear(d, d, dt, **kw),
        wv=init_linear(d, d, dt, **kw), wg=init_linear(d, d, dt, **kw),
        wo=init_linear(d, d, dt, **kw),
        w0=full((d,), -6.0),
        decay_a=init_linear(d, DECAY_LORA, dt, **kw),
        decay_b=init_linear(DECAY_LORA, d, dt, **kw),
        u=_normal((H, hd), 0.5, dt, generator, device),
        ln_x=torch.ones((d,), dtype=dt, device=device),
        cm_mu=full((2, d), 0.5),
        cm_k=init_linear(d, cfg.d_ff, dt, **kw),
        cm_v=init_linear(cfg.d_ff, d, dt, **kw),
        cm_r=init_linear(d, d, dt, **kw))


def _token_shift(x, last):
    """shift right by one along S; position 0 takes ``last`` (B, d)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunked(r, k, v, logw, u, s0, chunk=RWKV_CHUNK):
    """Chunked RWKV-6 wkv.  r,k,v: (B,S,H,D); logw: (B,S,H,D) (<=0, fp32);
    u: (H,D); s0: (B,H,Dk,Dv) fp32.  Returns o (B,S,H,D) fp32, s_last.

    With D_i = sum_{t<=i} logw_t within a chunk (the decay applied after
    the token is added, S_t = diag(w_t) S_{t-1} + k_t^T v_t, o_t read from
    S_{t-1}):
      o_i = (r_i exp(D_{i-1})) S_prev
            + sum_{j<i} (sum_c r_ic exp(D_{i-1,c} - D_{j,c}) k_jc) v_j
            + (r_i . (u * k_i)) v_i
      S'  = exp(D_C) S_prev + sum_j (exp(D_C - D_j) k_j)^T v_j
    Every exponent is <= 0.  One chunk's pairwise (B, H, C, C, D) tensor
    at a time, the chunks in a loop (the reference's ``lax.scan``)."""
    B, S, H, D = r.shape
    assert S % chunk == 0, (S, chunk)
    n = S // chunk

    def chunks(t):
        return t.reshape(B, n, chunk, H, D).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    uf = u.float()
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)  # j < i
    s = s0.float()
    outs = []
    for c in range(n):
        rch, kch, vch, wch = rc[c], kc[c], vc[c], wc[c]  # (B,H,C,D)
        Dcum = torch.cumsum(wch, dim=2)
        Dprev = Dcum - wch                                # sum_{t<i}
        o_state = torch.einsum("bhcd,bhde->bhce", rch * torch.exp(Dprev), s)
        expo = Dprev[:, :, :, None, :] - Dcum[:, :, None, :, :]  # (B,H,i,j,D)
        expo = torch.where(lower[None, None, :, :, None], expo, -torch.inf)
        att = torch.einsum("bhid,bhijd->bhij", rch,
                           torch.exp(expo) * kch[:, :, None, :, :])
        diag = torch.einsum("bhid,hd->bhi", rch * kch, uf)
        o_intra = torch.einsum("bhij,bhjd->bhid", att, vch) \
            + diag[..., None] * vch
        k_dec = kch * torch.exp(Dcum[:, :, -1:, :] - Dcum)  # exp(D_C - D_j)
        s = torch.exp(Dcum[:, :, -1, :])[..., None] * s + torch.einsum(
            "bhjd,bhje->bhde", k_dec, vch)
        outs.append(o_state + o_intra)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, D)
    return o, s


def _group_norm(x, scale, eps, H):
    """Per-head layer norm of (B,S,H*D) grouped by head."""
    B, S, d = x.shape
    xg = x.reshape(B, S, H, d // H).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    y = (xg - mu) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, d) * scale.float()).to(x.dtype)


def rwkv_inputs(p: RWKV, cfg, x, dtype, last):
    """The time-mix's token-shifted projections of x (B, S, d): r, k, v
    (B, S, H, D) in ``dtype``, the gate g (B, S, d) and the fp32 log
    decays logw (B, S, H, D), all <= 0.  ``last`` (B, d) is the token
    before x."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, last.to(dtype))
    mu = p.mu.to(dtype)
    xr, xk, xv, xg, xw = (x + (xs - x) * mu[i] for i in range(5))
    r = linear(p.wr, xr, dtype).reshape(B, S, H, hd)
    k = linear(p.wk, xk, dtype).reshape(B, S, H, hd)
    v = linear(p.wv, xv, dtype).reshape(B, S, H, hd)
    g = F.silu(linear(p.wg, xg, dtype))
    dec = linear(p.decay_b, torch.tanh(linear(p.decay_a, xw, dtype)), dtype)
    logw = -torch.exp(torch.clamp(p.w0.float() + dec.float(), -20.0, 4.0))
    return r, k, v, g, logw.reshape(B, S, H, hd)


def rwkv_time_mix(p: RWKV, cfg, x, dtype, *, mode="train",
                  state: Optional[RWKVState] = None):
    """RWKV-6 time-mix sub-block (the caller applies the pre-norm and adds
    the residual; channel-mix is the separate ``rwkv_channel_mix``)."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    last = (state.tm_last if state is not None
            else x.new_zeros((B, d), dtype=dtype))
    r, k, v, g, logw = rwkv_inputs(p, cfg, x, dtype, last)

    s0 = (state.s if state is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=x.device))
    if mode == "decode":  # S == 1: the exact single step
        rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))  # (B,H,D)
        uf = p.u.float()
        o = (torch.einsum("bhd,bhde->bhe", rf, s0)
             + torch.sum(rf * uf[None] * kf, dim=-1, keepdim=True) * vf)
        s_new = torch.exp(logw[:, 0])[..., None] * s0 \
            + kf[..., None] * vf[:, :, None, :]
        o = o[:, None].reshape(B, 1, d)
    else:
        o, s_new = _wkv_chunked(r, k, v, logw, p.u, s0,
                                chunk=min(RWKV_CHUNK, S))
        o = o.reshape(B, S, d)
    o = _group_norm(o.to(dtype), p.ln_x, 64e-5, H) * g
    out = linear(p.wo, o, dtype)
    new_state = None
    if mode != "train":
        new_state = RWKVState(s=s_new, tm_last=x[:, -1, :],
                              cm_last=x.new_zeros((B, d)))
    return out, new_state


def rwkv_channel_mix(p: RWKV, cfg, x, dtype, *, mode="train", last=None):
    """RWKV channel-mix; returns (out, the last input (B, d) | None)."""
    B, S, d = x.shape
    lastv = last if last is not None else x.new_zeros((B, d), dtype=dtype)
    xs = _token_shift(x, lastv.to(dtype))
    mu = p.cm_mu.to(dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(linear(p.cm_k, xk, dtype)))
    kv = linear(p.cm_v, k, dtype)
    out = torch.sigmoid(linear(p.cm_r, xr, dtype)) * kv
    new_last = x[:, -1, :] if mode != "train" else None
    return out, new_last
