"""RWKV-6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

``wkv_recurrent`` replaces the Pallas TPU kernel
``repro/kernels/wkv.py::wkv_recurrent``, the exact sequential recurrence

    o_t = r_t S + (sum r_t u k_t) v_t;   S <- diag(exp(logw_t)) S + k_t^T v_t

over (BH, T, D) r/k/v/logw and (BH, D) u with a D x D fp32 state.  Its
kernel (csrc/wkv.cu) is bound by bytes on the H100: one thread per state
column, the column in registers, grid (BH, D / min(D, 32)), the step
inputs staged through shared memory a chunk at a time.  Nothing in the
port's model calls it yet (the JAX package's RWKV blocks use a chunked
jnp form too): ``ops.wkv_recurrent`` is its entry.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)


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
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}; the kernel takes "
                         f"{HEAD_DIMS}")
    if r.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != r.dtype for t in ins.values()):
        raise ValueError(f"{name}: inputs must share float32 or bfloat16, "
                         f"got {[str(t.dtype) for t in ins.values()]}")
    if BH < 1 or T < 1:
        raise ValueError(f"{name}: BH = {BH}, T = {T} out of range")
    _b.check_cuda(name, r.device, **ins)
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
