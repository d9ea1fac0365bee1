"""ABFT column checksums ``c = A^T 1`` of DIA operators.

For an SpMV ``y = A v`` the identity ``1^T y == (A^T 1)^T v == c^T v``
lets every fused sweep verify its own SpMV: the checksum residual
``1^T (A v) - c^T v`` is rounding-level when the sweep ran faithfully and
O(corruption) otherwise.  ``c`` is loop-invariant: the engine computes it
once per solve and hands it to the fused kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def dia_column_checksum(offsets: Sequence[int], bands: torch.Tensor, *,
                        halo: int = 0) -> torch.Tensor:
    """Column sums ``c = A^T 1`` of a DIA operator, per local column.

    ``bands`` is ``(n_bands, n + 2*halo)`` — the plain band array
    (``halo=0``) or a halo-extended local slice (rows ``-h .. n+h-1``).
    Returns ``c`` of length ``n``: ``c[j] = sum_k bands[k, j - offsets[k]]``
    over the rows the band array can see, summed in band order in the
    bands' dtype.
    """
    _, ncols = bands.shape
    n = ncols - 2 * halo
    h = max(max(abs(int(o)) for o in offsets), halo)
    ext = F.pad(bands, (h - halo, h - halo))
    c = torch.zeros((n,), dtype=bands.dtype, device=bands.device)
    for k, off in enumerate(offsets):
        # column j is written by row j - off, whose band value sits at
        # extended index (j - off) + h
        c = c + ext[k, h - off:h - off + n]
    return c
