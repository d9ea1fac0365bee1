"""Mixture-of-Experts FFN with sort-based dispatch.

The port of the JAX package's ``models/moe.py``:
  1. router logits (T, E) in fp32 -> top-k expert ids + renormalised
     weights, the Switch load-balancing loss and the router z-loss;
  2. flatten the (T, k) assignments, stable-argsort them by expert id;
  3. position within each expert from the segment starts; assignments past
     the per-expert capacity C = ceil(k*T/E * capacity_factor) (rounded up
     to a multiple of 8) are DROPPED (Switch-style);
  4. an (E, C) table of assignment slots (sentinel T*k for an empty slot)
     gathers the tokens -> (E, C, d); the expert FFN runs as batched
     matrix products (SwiGLU, or tanh-GELU when not gated);
  5. combine: each token sums its k weighted expert rows in k order,
     through the inverse (T, k) -> slot map.

The reference scatter-adds the expert rows into the tokens; the port
gathers them back instead, so no float atomics decide the summation order
and two runs give the same bits (the order the plain versions of the
kernels keep, ROADMAP.md H2).  Gathers at the sentinel read an extra zero
row, where the reference reads ``jnp.take(..., mode="fill")``'s zeros.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _normal, _param, init_linear


class MoE(nn.Module):
    """Router (d, E) and the stacked expert weights: up / gate (E, d, f),
    down (E, f, d)."""

    def __init__(self, router: Linear, up: torch.Tensor, down: torch.Tensor,
                 gate: torch.Tensor = None):
        super().__init__()
        self.router = router
        self.up = _param(up)
        self.down = _param(down)
        self.gate = None if gate is None else _param(gate)


def capacity(cfg_moe, num_tokens: int) -> int:
    c = int(math.ceil(cfg_moe.top_k * num_tokens / cfg_moe.num_experts
                      * cfg_moe.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def init_moe(cfg, *, generator: torch.Generator, device="cuda") -> MoE:
    m = cfg.moe
    d = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    std = 1.0 / math.sqrt(d)
    router = init_linear(d, m.num_experts, dt, generator=generator,
                         device=device)
    up = _normal((m.num_experts, d, m.d_ff), std, dt, generator, device)
    down = _normal((m.num_experts, m.d_ff, d), 1.0 / math.sqrt(m.d_ff), dt,
                   generator, device)
    gate = (_normal((m.num_experts, d, m.d_ff), std, dt, generator, device)
            if cfg.gated_mlp else None)
    return MoE(router, up, down, gate)


def moe_ffn(p: MoE, cfg, x: torch.Tensor, dtype):
    """x (B, S, d) -> (B, S, d) and the aux dict: ``moe_aux`` (Switch),
    ``moe_z`` (router z-loss) and ``moe_dropped``, the (token, expert)
    assignments dropped at capacity (an integer tensor)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    C = capacity(m, T)
    dev = x.device
    xf = x.reshape(T, d)

    # --- router (fp32) -----------------------------------------------------
    logits = xf.float() @ p.router.w.float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate_w, gate_idx = torch.topk(probs, K, dim=-1)              # (T, K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, E).float().sum(1).mean(dim=0)
    aux_loss = E * torch.sum(me * ce) / K
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # --- sort-based dispatch ------------------------------------------------
    flat_e = gate_idx.reshape(-1)                                # (T*K,)
    flat_w = gate_w.reshape(-1).to(dtype)
    sort_idx = torch.argsort(flat_e, stable=True)                # (T*K,)
    sorted_e = flat_e[sort_idx]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                   side="left")
    pos_in_e = torch.arange(T * K, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)    # overflow bin
    table = torch.full((E * C + 1,), T * K, dtype=torch.long, device=dev)
    table[slot] = sort_idx               # the overflow bin is cut off below
    table = table[:E * C].reshape(E, C)                          # (E, C)
    # assignment t*K + k -> its slot (E*C when dropped): the combine's map
    slot_of = torch.empty_like(slot)
    slot_of[sort_idx] = slot

    tok_of = table // K                                  # sentinel -> T
    w_of = torch.cat([flat_w, flat_w.new_zeros(1)])[table]       # (E, C)
    xpad = torch.cat([xf.to(dtype), xf.new_zeros((1, d), dtype=dtype)])
    gx = xpad[tok_of]                                            # (E, C, d)

    # --- expert compute (batched matrix products) ----------------------------
    up = torch.bmm(gx, p.up.to(dtype))
    if cfg.gated_mlp:
        up = F.silu(torch.bmm(gx, p.gate.to(dtype))) * up
    else:
        up = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default form
    out_e = torch.bmm(up, p.down.to(dtype))                      # (E, C, d)

    # --- combine: each token's k rows, in k order ----------------------------
    rows = torch.cat([(out_e * w_of[..., None]).reshape(E * C, d),
                      out_e.new_zeros((1, d))])
    slot_tk = slot_of.reshape(T, K)
    out = torch.zeros((T, d), dtype=dtype, device=dev)
    for k in range(K):
        out = out + rows[slot_tk[:, k]]
    dropped = torch.count_nonzero(~keep)
    return out.reshape(B, S, d), {"moe_aux": aux_loss, "moe_z": z_loss,
                                  "moe_dropped": dropped}
