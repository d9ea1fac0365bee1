"""Carry operators and options across from the JAX reference package.

Works on plain numpy arrays and names, so it needs nothing of the
reference at run time: ``dia_from_numpy(A.offsets, np.asarray(A.bands))``
rebuilds a reference ``DiaMatrix`` here with the same ``fingerprint()``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def policy_from_name(name: str) -> PrecisionPolicy:
    """The port's ``PrecisionPolicy`` for a reference preset name."""
    return PrecisionPolicy.from_name(name)
