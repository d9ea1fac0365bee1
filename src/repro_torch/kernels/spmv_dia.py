"""Banded (DIA) SpMV: the CUDA kernel's wrapper and its plain version.

``spmv_dia`` replaces the Pallas TPU kernel
``repro/kernels/spmv_dia.py::spmv_dia``.  Its kernel (csrc/spmv_dia.cu) is
bound by bytes on the H100: n_bands + 2 words per row (5n for the
tridiagonal ex23 operator).  It reads x unpadded and masks the ragged edge
and the +-h neighbour rows itself; see the source for the design.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build as _b


def spmv_dia_plain(offsets: Sequence[int], bands: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y[..., i] = sum_k bands[k, i] * x[..., i + offsets[k]] in plain torch.

    Follows the reference oracle term for term: start from zeros and add
    the band terms in band order; rows outside [0, n) read zero.  ``x`` is
    (n,) or (k, n); ``y`` has x's dtype (bands are widened to it).
    """
    n = x.shape[-1]
    h = max(abs(int(o)) for o in offsets)
    x_ext = torch.nn.functional.pad(x, (h, h))
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + bands[k].to(x.dtype) * x_ext[..., h + off:h + off + n]
    return y


def spmv_dia(offsets: Sequence[int], bands: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Banded SpMV ``y = A x`` for x (n,) or (k, n).

    A CUDA ``x`` launches the CUDA kernel (or raises); a CPU ``x`` takes
    :func:`spmv_dia_plain`.  ``spmv_dia.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        if bands.device != x.device:
            raise ValueError(f"spmv_dia: bands on {bands.device}, x on cpu")
        return spmv_dia_plain(offsets, bands, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_dia: no kernel for device {x.device}")
    n = x.shape[-1]
    k = 1 if x.dim() == 1 else x.shape[0]
    nb = len(offsets)
    if x.dim() not in (1, 2) or bands.shape != (nb, n):
        raise ValueError(f"spmv_dia: bands {tuple(bands.shape)} and x "
                         f"{tuple(x.shape)} do not fit {nb} offsets")
    if not 1 <= nb <= _b.MAX_BANDS:
        raise ValueError(f"spmv_dia: {nb} bands, the kernel takes 1.."
                         f"{_b.MAX_BANDS}")
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"spmv_dia: x must be float32 or float64, got "
                         f"{x.dtype}")
    _b.check_cuda("spmv_dia", x.device, bands=bands, x=x)
    y = torch.empty_like(x)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_spmv_dia(
            _b.dtype_code("spmv_dia", x), _b.dtype_code("spmv_dia", bands),
            offs, nb, n, k, _b.ptr(bands), _b.ptr(x), _b.ptr(y),
            _b.stream_of(x.device))
    _b.raise_on_error("spmv_dia", rc)
    spmv_dia.launches += 1
    return y


spmv_dia.launches = 0
