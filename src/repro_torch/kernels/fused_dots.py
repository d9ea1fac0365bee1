"""Fused multi-vector inner products: the CUDA kernel's wrapper + plain version.

``fused_dots`` replaces the Pallas TPU kernel
``repro/kernels/fused_dots.py::fused_dots``: ``dots[j] = <V[j], z>`` for
V (m, n) and z (n,), all m coefficients in one pass over V.  Its kernel
(csrc/fused_dots.cu) is bound by bytes on the H100, (m + 1) n words: at
most :data:`MAX_BLOCKS` CTAs, each thread with its z in registers for
every row of V, 16-byte loads where n and the pointers allow; each CTA
writes a row of partials and the last CTA to arrive finishes them in a
fixed order, in the same launch (integer tickets, no float atomics).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.pipecg_spmv_fused import tickets

#: rows of V a block reduction, and the width of a partial row: the
#: first where m is at most it, else the last (ROWS in csrc/fused_dots.cu)
ROWS = (4, 8)
#: CTAs a launch aims at, two an SM on the H100's 132 (kDotsMaxBlocks)
MAX_BLOCKS = 264
#: bytes of a vector load (kDotsVecBytes)
VEC_BYTES = 16
#: vectors a thread may take, the fewest that keep the grid in MAX_BLOCKS
ITEMS = (1, 2, 4, 8)


def dots_plan(m: int, n: int, itemsize: int, aligned: bool = True
              ) -> Tuple[int, int, int, int, int]:
    """(width, items, rows, nblk, groups) of a launch on V (m, n).

    ``width`` columns a load: 16 bytes' worth where ``aligned`` (V and z
    start on 16 bytes) and it divides n, else 1.  ``items`` vectors a
    thread: the fewest of :data:`ITEMS` that keep ``nblk`` within
    :data:`MAX_BLOCKS` (the most where none does).  ``rows`` of V a block
    reduction (:data:`ROWS`), in ``groups``: the partials scratch is
    (groups, nblk, rows).
    """
    vec = VEC_BYTES // itemsize
    width = vec if aligned and n % vec == 0 else 1
    nv = n // width
    for items in ITEMS:
        nblk = -(-nv // (_b.BLOCK * items))
        if nblk <= MAX_BLOCKS:
            break
    rows = ROWS[0] if m <= ROWS[0] else ROWS[-1]
    return width, items, rows, nblk, -(-m // rows)


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
    width, items, rows, nblk, groups = dots_plan(
        m, n, z.element_size(),
        V.data_ptr() % VEC_BYTES == 0 and z.data_ptr() % VEC_BYTES == 0)
    partials = torch.empty((groups, nblk, rows), dtype=z.dtype,
                           device=z.device)
    out = torch.empty((m,), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        rc = _b.lib().rt_fused_dots(
            _b.dtype_code(name, z), _b.ptr(V), _b.ptr(z), n, m, width, items,
            rows, _b.ptr(partials), nblk, _b.ptr(tickets(z.device, 1)),
            _b.ptr(out), _b.stream_of(z.device))
    _b.raise_on_error(name, rc)
    fused_dots.launches += 1
    return out


fused_dots.launches = 0
