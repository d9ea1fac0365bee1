"""The PIPECG update-only fallback: the CUDA kernel's wrapper + plain version.

``pipecg_fused`` replaces the Pallas TPU kernel
``repro/kernels/pipecg_fused.py::pipecg_fused``: the eight PIPECG AXPYs
over the 10-vector state plus the next iteration's <r',u'>, <w',u'>,
<r',r'>, for a callable M or a matrix-free A (the M-apply and the SpMV
stay with the caller).  Its kernel (csrc/pipecg_fused.cu) is bound by
bytes on the H100: 10 reads + 8 writes = 18 words per row.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build as _b

NVEC = 10  # x, r, u, w, m, n, z, q, s, p


def pipecg_fused_plain(x, r, u, w, m, n_, z, q, s, p, alpha, beta
                       ) -> Tuple[torch.Tensor, ...]:
    """The eight updates and three dots in plain torch, as the oracle.

    Vectors (k, n), alpha/beta (k,).  Returns (x', r', u', w', z', q', s',
    p', red (k, 3)).
    """
    a = alpha[:, None]
    b = beta[:, None]
    z2 = n_ + b * z
    q2 = m + b * q
    s2 = w + b * s
    p2 = u + b * p
    x2 = x + a * p2
    r2 = r - a * s2
    u2 = u - a * q2
    w2 = w - a * z2
    red = torch.stack([torch.sum(r2 * u2, dim=-1), torch.sum(w2 * u2, dim=-1),
                       torch.sum(r2 * r2, dim=-1)], dim=-1)
    return x2, r2, u2, w2, z2, q2, s2, p2, red


def pipecg_fused(x, r, u, w, m, n_, z, q, s, p, alpha, beta
                 ) -> Tuple[torch.Tensor, ...]:
    """Fused PIPECG updates + dots for k right-hand sides.

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`pipecg_fused_plain`.  ``pipecg_fused.launches`` counts launches.
    """
    vecs = (x, r, u, w, m, n_, z, q, s, p)
    if x.device.type == "cpu":
        for t in vecs[1:] + (alpha, beta):
            if t.device != x.device:
                raise ValueError(f"pipecg_fused: operands on {t.device} "
                                 "and cpu")
        return pipecg_fused_plain(*vecs, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"pipecg_fused: no kernel for {x.device}")
    name = "pipecg_fused"
    k, n = x.shape
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: vectors must be float32 or float64")
    for i, t in enumerate(vecs):
        if tuple(t.shape) != (k, n) or t.dtype != x.dtype:
            raise ValueError(f"{name}: vector {i} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {(k, n)} {x.dtype}")
    for key, t in (("alpha", alpha), ("beta", beta)):
        if tuple(t.shape) != (k,) or t.dtype != x.dtype:
            raise ValueError(f"{name}: {key} must be ({k},) {x.dtype}")
    _b.check_cuda(name, x.device, alpha=alpha, beta=beta,
                  **{f"v{i}": t for i, t in enumerate(vecs)})
    outs = tuple(torch.empty_like(x) for _ in range(8))
    nblk = -(-n // _b.BLOCK)
    partials = torch.empty((k, nblk, 3), dtype=x.dtype, device=x.device)
    red = torch.empty((k, 3), dtype=x.dtype, device=x.device)
    ins = (ctypes.c_void_p * NVEC)(*[t.data_ptr() for t in vecs])
    outp = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in outs])
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipecg_fused(
            _b.dtype_code(name, x), n, k, ins, outp, _b.ptr(alpha),
            _b.ptr(beta), _b.ptr(partials), nblk, _b.ptr(red),
            _b.stream_of(x.device))
    _b.raise_on_error(name, rc)
    pipecg_fused.launches += 1
    return outs + (red,)


pipecg_fused.launches = 0
