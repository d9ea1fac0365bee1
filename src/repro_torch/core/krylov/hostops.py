"""Host-side (numpy) operator applications for the ground-truth checks.

A true residual ``||b - A x||`` computed on the host, outside the solve,
is a check a corrupted device recurrence cannot influence.  DIA operators
go through :func:`dia_matvec_np` (the padded-gather fold of
``operators.dia_gather_matvec``, in numpy); any other ``SparseOperator``
supplies its own ``host_matvec`` (``BsrMatrix`` does).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def dia_matvec_np(offsets: Sequence[int], bands: np.ndarray,
                  x: np.ndarray) -> np.ndarray:
    """Host-numpy DIA matvec ``y = A x`` (DiaMatrix band convention).

    ``A[i, i + off_k] = bands[k, i]``; ``x`` may carry leading batch
    dimensions.  ``x`` is zero-padded by the halo and the band terms are
    folded left to right in band order, as ``dia_gather_matvec`` does.
    """
    bands, x = np.asarray(bands), np.asarray(x)
    n = x.shape[-1]
    offs = [int(o) for o in offsets]
    h = max((abs(o) for o in offs), default=0)
    x_ext = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(h, h)])
    y = bands[0] * x_ext[..., h + offs[0]:h + offs[0] + n]
    for k, o in enumerate(offs[1:], start=1):
        y = y + bands[k] * x_ext[..., h + o:h + o + n]
    return y


def true_residual_norm(A, b: np.ndarray, x: np.ndarray) -> float:
    """``||b - A x||_2`` on the host, in float64, for a ``SparseOperator``.

    A DIA operator (one with ``bands``) goes through :func:`dia_matvec_np`,
    any other through its ``host_matvec``.  ``b`` and ``x`` may be numpy
    arrays or tensors on any device.
    """
    b = _host(b)
    x64 = _host(x)
    if hasattr(A, "bands"):
        bands = A.bands.detach().to("cpu", torch.float64).numpy()
        ax = dia_matvec_np(A.offsets, bands, x64)
    else:
        ax = A.host_matvec(x64)
    return float(np.linalg.norm(b - np.asarray(ax, np.float64)))


def _host(v) -> np.ndarray:
    """float64 numpy copy of an array or a tensor."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)
