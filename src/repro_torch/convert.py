"""Carry operators and options across from the JAX reference package.

Works on plain numpy arrays and names, so it needs nothing of the
reference at run time: ``dia_from_numpy(A.offsets, np.asarray(A.bands))``
rebuilds a reference ``DiaMatrix`` here with the same ``fingerprint()``,
``bsr_from_numpy(np.asarray(A.indices), np.asarray(A.blocks))`` a
reference ``BsrMatrix``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.krylov.operator import BsrMatrix
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import PrecisionPolicy


def dia_from_numpy(offsets: Sequence[int], bands: np.ndarray,
                   grid_shape: Optional[Tuple[int, int]] = None,
                   device="cuda") -> DiaMatrix:
    """A ``DiaMatrix`` over a copy of ``bands`` (dtype and bytes kept)."""
    arr = np.ascontiguousarray(bands)
    return DiaMatrix(offsets=tuple(int(o) for o in offsets),
                     bands=torch.from_numpy(arr.copy()).to(device),
                     grid_shape=None if grid_shape is None
                     else (int(grid_shape[0]), int(grid_shape[1])))


def bsr_from_numpy(indices: np.ndarray, blocks: np.ndarray,
                   device="cuda") -> BsrMatrix:
    """A ``BsrMatrix`` over copies of ``indices`` (as int32) and ``blocks``
    (dtype and bytes kept)."""
    ind = np.ascontiguousarray(indices, dtype=np.int32)
    blk = np.ascontiguousarray(blocks)
    return BsrMatrix(indices=torch.from_numpy(ind.copy()).to(device),
                     blocks=torch.from_numpy(blk.copy()).to(device))


def policy_from_name(name: str) -> PrecisionPolicy:
    """The port's ``PrecisionPolicy`` for a reference preset name."""
    return PrecisionPolicy.from_name(name)
