"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention`` replaces the Pallas TPU kernel
``repro/kernels/flash_attn.py::flash_attention``: causal or full softmax
attention over (BH, S, D) q/k/v with the S x S scores kept on chip.  Its
kernel (csrc/flash_attn.cu) is bound by operations on the H100 (about S/2
flops per byte in bf16).  bfloat16 inputs run on the tensor cores
(``wgmma`` bf16 -> fp32, two warpgroups per 128-row q tile, k/v tiles by
``cp.async`` into two 128-byte-swizzled shared-memory stages, the softmax
online in registers, P rounded to bf16 in registers as the A operand of
the P V product); float32 inputs on the CUDA cores.
Both stop the causal kv loop at the diagonal tile and mask the ragged S
edge themselves, so nothing pads (the reference pads S to 128, which lets
the padded keys into a non-causal softmax: ROADMAP.md H12).

Rounding P to bf16 is what FlashAttention does, and what the Pallas
kernel's ``p @ v`` gets at the TPU's default matmul precision; it takes
the bf16 kernel off one-ulp agreement with the fp32-P plain version.
:func:`bf16_error` states the bar it is held to instead.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build as _b

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """(BH, S, D) attention in plain torch, the reference oracle's steps:
    fp32 scores, -1e30 mask, softmax, then a cast to q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def bf16_error(got: torch.Tensor, want: torch.Tensor,
               v: torch.Tensor) -> Tuple[float, float]:
    """How far a bf16 ``got`` lies from the float32 oracle ``want``, as
    fractions of the bar (the bar holds when both are at most 1; NaN fails).

    Rounding each probability to bf16 moves an output by at most
    2^-9 sum_j p_j |v_j| / l <= 2^-9 max_j |v_j| (the max over the head's
    keys, column by column), and rounding the output to bf16 by at most
    2^-8 |o|.  So the elementwise bar is
    |got - want| <= 2^-8 |want| + 2^-8 max_j |v_j|, and the aggregate bar
    rms(got - want) <= 2^-8 rms(want), which catches a dropped kv tile or
    an off-by-one mask that moves only late rows by a few percent.

    Returns (max of |got - want| over its elementwise bar,
    rms(got - want) over 2^-8 rms(want)).
    """
    gap = (got.float() - want.float()).abs()
    vmax = v.float().abs().amax(dim=-2, keepdim=True)
    elem = gap / (2.0 ** -8 * (want.float().abs() + vmax))
    rms = gap.pow(2).mean().sqrt() / (
        2.0 ** -8 * want.float().pow(2).mean().sqrt())
    return float(elem.max()), float(rms)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward for q, k, v (BH, S, D); returns (BH, S, D) in q's
    dtype.

    CUDA tensors launch the CUDA kernel (float32 or bfloat16, D 64 or 128,
    contiguous, one shape for all three) or raise; CPU tensors take
    :func:`flash_attention_plain`.  ``flash_attention.launches`` counts
    kernel launches.
    """
    name = "flash_attention"
    if q.device.type == "cpu":
        if k.device != q.device or v.device != q.device:
            raise ValueError(f"{name}: k on {k.device}, v on {v.device}, "
                             "q on cpu")
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not one (BH, S, D) shape")
    BH, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= BH <= 65535 or S < 1:
        raise ValueError(f"{name}: BH = {BH}, S = {S} out of range")
    _b.check_cuda(name, q.device, q=q, k=k, v=v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _b.lib().rt_flash_attention(
            _b.dtype_code(name, q), _b.ptr(q), _b.ptr(k), _b.ptr(v),
            _b.ptr(o), BH, S, D, 1.0 / math.sqrt(D), int(causal),
            _b.stream_of(q.device))
    _b.raise_on_error(name, rc)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
