"""Fused multi-vector inner products: the CUDA kernel's wrapper + plain version.

``fused_dots`` replaces the Pallas TPU kernel
``repro/kernels/fused_dots.py::fused_dots``: ``dots[j] = <V[j], z>`` for
V (m, n) and z (n,), all m coefficients in one pass over V.  Its kernel
(csrc/fused_dots.cu) is bound by bytes on the H100, (m + 1) n words: each
CTA reads its tile of z once, writes (m, n_blocks) partials, and a
fixed-order second pass finishes them (no float atomics).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

#: columns per CTA (kTile in csrc/fused_dots.cu); sizes the partials scratch
TILE = 4 * _b.BLOCK


def fused_dots_plain(V: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """dots[j] = sum_i V[j, i] * z[i] in plain torch; V (m, n), z (n,)."""
    return torch.sum(V * z, dim=-1)


def fused_dots(V: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """All m inner products ``V @ z`` in one pass; returns (m,).

    A CUDA ``z`` launches the CUDA kernel (or raises); a CPU ``z`` takes
    :func:`fused_dots_plain`.  ``fused_dots.launches`` counts launches.
    """
    name = "fused_dots"
    if z.device.type == "cpu":
        if V.device != z.device:
            raise ValueError(f"{name}: V on {V.device}, z on cpu")
        return fused_dots_plain(V, z)
    if z.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {z.device}")
    if V.dim() != 2 or z.dim() != 1 or V.shape[1] != z.shape[0] \
            or V.shape[0] < 1 or z.shape[0] < 1:
        raise ValueError(f"{name}: V {tuple(V.shape)} and z "
                         f"{tuple(z.shape)} are not (m, n) and (n,)")
    if z.dtype not in _b.ACCUM_DTYPES or V.dtype != z.dtype:
        raise ValueError(f"{name}: V and z must share float32 or float64, "
                         f"got {V.dtype} and {z.dtype}")
    _b.check_cuda(name, z.device, V=V, z=z)
    m, n = V.shape
    nblk = -(-n // TILE)
    partials = torch.empty((m, nblk), dtype=z.dtype, device=z.device)
    out = torch.empty((m,), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        rc = _b.lib().rt_fused_dots(
            _b.dtype_code(name, z), _b.ptr(V), _b.ptr(z), n, m,
            _b.ptr(partials), nblk, _b.ptr(out), _b.stream_of(z.device))
    _b.raise_on_error(name, rc)
    fused_dots.launches += 1
    return out


fused_dots.launches = 0
