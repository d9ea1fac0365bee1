"""ABFT column checksums ``c = A^T 1`` of DIA and BSR operators.

For an SpMV ``y = A v`` the identity ``1^T y == (A^T 1)^T v == c^T v``
lets every fused sweep verify its own SpMV: the checksum residual
``1^T (A v) - c^T v`` is rounding-level when the sweep ran faithfully and
O(corruption) otherwise.  ``c`` is loop-invariant: the engine computes it
once per solve and hands it to the fused kernel.

No float atomics: the BSR checksum, a scatter-add in the JAX package, is
a fixed-order segment sum here (gather per column), so it has the same
bits on every run and on either device.
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


def bsr_column_checksum(indices: torch.Tensor,
                        blocks: torch.Tensor) -> torch.Tensor:
    """Column sums ``c = A^T 1`` of a blocked-ELL (BSR) operator.

    ``indices`` (nbr, deg) int32, ``blocks`` (nbr, deg, bs, bs); pads are
    self-pointing zero blocks and add zeros.  Each stored block's column
    sums (rows added in order) go to the block column it names.  The
    entries of one block column are listed in (block row, slot) order by
    a stable sort, padded to the largest in-degree with a zero entry, and
    summed slot by slot: a fixed-order segment sum, where the reference
    scatter-adds.  Returns ``c`` of length ``nbr * bs``.
    """
    nbr, deg = indices.shape
    bs = blocks.shape[-1]
    colsums = blocks[..., 0, :]
    for i in range(1, bs):
        colsums = colsums + blocks[..., i, :]          # (nbr, deg, bs)
    cols = indices.reshape(-1).long()
    nnz = cols.numel()
    order = torch.argsort(cols, stable=True)
    counts = torch.bincount(cols, minlength=nbr)
    col_sorted = cols[order]
    slot = torch.arange(nnz, device=cols.device) \
        - (torch.cumsum(counts, 0) - counts)[col_sorted]
    width = int(counts.max()) if nnz else 0
    table = torch.full((nbr, width), nnz, dtype=torch.long,
                       device=cols.device)        # nnz: the zero entry
    table[col_sorted, slot] = order
    src = torch.cat([colsums.reshape(nnz, bs),
                     torch.zeros((1, bs), dtype=blocks.dtype,
                                 device=blocks.device)])
    c = torch.zeros((nbr, bs), dtype=blocks.dtype, device=blocks.device)
    for t in range(width):
        c = c + src[table[:, t]]
    return c.reshape(nbr * bs)
