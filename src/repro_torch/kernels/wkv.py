"""RWKV-6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

``wkv_recurrent`` replaces the Pallas TPU kernel
``repro/kernels/wkv.py::wkv_recurrent``, the exact sequential recurrence

    o_t = r_t S + (sum r_t u k_t) v_t;   S <- diag(exp(logw_t)) S + k_t^T v_t

over (BH, T, D) r/k/v/logw and (BH, D) u with a D x D fp32 state.  Its
kernel (csrc/wkv.cu) has to run at the byte rate and the FP32 pipes'
rate together on the H100: one CTA a head (two at D = 128), each thread
a block of rows by columns of the state in registers (8 x 4 at D = 64),
so that every word it reads from shared memory serves several FMAs, the
row slices of a column summed by a warp-shuffle butterfly, the steps
software-pipelined, and the step inputs staged a chunk of steps at a
time by bulk copies into a two-stage ring (:func:`wkv_plan`).
The model's RWKV block does not call it: like the JAX package's, it runs
the chunked form with a carried state (``models/recurrent.py::
_wkv_chunked``), and the kernel takes no initial state and returns no
last one.  ``ops.wkv_recurrent`` is its entry; chip_smoke.py holds the
kernel and the chunked form together from a zero state on rwkv6-7b's
layer 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build as _b

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: steps a stage (halved at D = 128) and stages of the ring: kWkvChunk and
#: kWkvStages in csrc/wkv.cu
CHUNK = 32
STAGES = 2
#: state rows and columns a thread, and CTAs a head, by head dim (the
#: WkvPlan specialisations of csrc/wkv.cu)
SHAPES = {16: (4, 1, 1), 32: (4, 4, 1), 64: (8, 4, 1), 128: (8, 8, 2)}
#: alignment of r, k, v and logw (16-byte cp.async)
ALIGN = 16


def wkv_plan(D: int, dtype: torch.dtype) -> Dict[str, int]:
    """The kernel's launch plan at head dim ``D`` for inputs of ``dtype``
    (csrc/wkv.cu's WkvPlan and wkv_smem): CTAs a head (``split``),
    ``threads`` a CTA, state ``rows`` and ``cols`` a thread, row ``slices``
    a column, steps a stage (``chunk``), ``stages`` of the ring, and the
    dynamic shared memory in bytes: the stages at the input's dtype, fp32
    exp(logw) (for bf16 inputs also fp32 r, k, v), the chunk's bonus,
    and u."""
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv_recurrent: head dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    rows, cols, split = SHAPES[D]
    slices = D // rows
    chunk = CHUNK // 2 if D > 64 else CHUNK
    size = torch.empty((), dtype=dtype).element_size()
    wide = 1 if dtype == torch.float32 else 4
    return dict(split=split, threads=slices * (D // split) // cols,
                rows=rows, cols=cols, slices=slices, chunk=chunk,
                stages=STAGES,
                smem=STAGES * 4 * chunk * D * size + wide * chunk * D * 4
                + (chunk + D) * 4)


def wkv_recurrent_plain(r, k, v, logw, u) -> torch.Tensor:
    """The recurrence step by step in plain torch (the reference oracle's
    order: output, then state update); returns (BH, T, D) float32."""
    BH, T, D = r.shape
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, logw, u))
    S = torch.zeros((BH, D, D), dtype=torch.float32, device=r.device)
    out = torch.empty((BH, T, D), dtype=torch.float32, device=r.device)
    for t in range(T):
        rt, kt, vt, lwt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        bonus = torch.sum(rt * uf * kt, dim=-1, keepdim=True)
        out[:, t] = torch.einsum("bd,bde->be", rt, S) + bonus * vt
        S = torch.exp(lwt)[..., None] * S + kt[..., None] * vt[:, None, :]
    return out


def wkv_recurrent(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The WKV recurrence for r/k/v/logw (BH, T, D) and u (BH, D); returns
    o (BH, T, D) float32.

    CUDA tensors launch the CUDA kernel (all float32 or all bfloat16, D in
    16/32/64/128, contiguous) or raise; CPU tensors take
    :func:`wkv_recurrent_plain`.  ``wkv_recurrent.launches`` counts kernel
    launches.
    """
    name = "wkv_recurrent"
    ins = dict(r=r, k=k, v=v, logw=logw, u=u)
    if r.device.type == "cpu":
        if any(t.device != r.device for t in ins.values()):
            raise ValueError(f"{name}: inputs on "
                             f"{[str(t.device) for t in ins.values()]}")
        return wkv_recurrent_plain(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {r.device}")
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, logw)) \
            or u.shape != (r.shape[0], r.shape[2]):
        raise ValueError(f"{name}: shapes "
                         f"{ {n: tuple(t.shape) for n, t in ins.items()} } "
                         "are not (BH, T, D) x 4 and (BH, D)")
    BH, T, D = r.shape
    wkv_plan(D, r.dtype)  # raises for a head dim with no kernel
    if r.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != r.dtype for t in ins.values()):
        raise ValueError(f"{name}: inputs must share float32 or bfloat16, "
                         f"got {[str(t.dtype) for t in ins.values()]}")
    if BH < 1 or T < 1:
        raise ValueError(f"{name}: BH = {BH}, T = {T} out of range")
    _b.check_cuda(name, r.device, **ins)
    if any(t.data_ptr() % ALIGN for t in (r, k, v, logw)):
        raise ValueError(f"{name}: r, k, v and logw must start on "
                         f"{ALIGN} bytes")
    o = torch.empty((BH, T, D), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = _b.lib().rt_wkv_recurrent(
            _b.dtype_code(name, r), _b.ptr(r), _b.ptr(k), _b.ptr(v),
            _b.ptr(logw), _b.ptr(u), _b.ptr(o), BH, T, D,
            _b.stream_of(r.device))
    _b.raise_on_error(name, rc)
    wkv_recurrent.launches += 1
    return o


wkv_recurrent.launches = 0
