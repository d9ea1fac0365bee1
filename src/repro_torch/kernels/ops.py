"""Dispatch to the kernel wrappers, and their launch counts.

Each wrapper dispatches on the device of its tensors: a CUDA tensor
launches the CUDA kernel or raises, a CPU tensor takes the plain torch
version.  The CUDA kernels mask the ragged row edge themselves, so nothing
here pads.  The step functions accept a single right-hand side ((n,)
vectors with 0-d alpha/beta) as well as a batch ((k, n) with (k,)).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels.pipecg_fused import pipecg_fused
from repro_torch.kernels.pipecg_spmv_fused import pipecg_spmv_fused
from repro_torch.kernels.spmv_dia import spmv_dia

#: every kernel wrapper of the package, by kernel name
KERNELS = {
    "spmv_dia": spmv_dia,
    "pipecg_spmv_fused": pipecg_spmv_fused,
    "pipecg_fused": pipecg_fused,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def _batch(x: torch.Tensor, vecs, alpha, beta):
    """(k, n) views of the vectors and (k,) scalars at x's dtype."""
    k = 1 if x.dim() == 1 else x.shape[0]
    vecs = tuple(v.reshape(k, -1).contiguous() for v in vecs)
    ab = tuple(torch.as_tensor(s, dtype=x.dtype, device=x.device)
               .reshape(k).contiguous() for s in (alpha, beta))
    return vecs, ab


def spmv_dia_step(offsets: Sequence[int], bands, x) -> torch.Tensor:
    """Banded SpMV for x (n,) or (k, n) (kernel-backed on CUDA)."""
    return spmv_dia(tuple(offsets), bands, x.contiguous())


def pipecg_spmv_fused_step(offsets: Sequence[int], bands, inv_diag, csum,
                           x, r, u, p, alpha, beta
                           ) -> Tuple[torch.Tensor, ...]:
    """Single-sweep PIPECG iteration (updates + Jacobi + SpMV + dots)."""
    squeeze = x.dim() == 1
    (x2, r2, u2, p2), (a, b) = _batch(x, (x, r, u, p), alpha, beta)
    outs = pipecg_spmv_fused(tuple(offsets), bands, inv_diag, csum,
                             x2, r2, u2, p2, a, b)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs


def pipecg_fused_step(x, r, u, w, m, n_, z, q, s, p, alpha, beta
                      ) -> Tuple[torch.Tensor, ...]:
    """Fused PIPECG updates + dots (the update-kernel fallback path)."""
    squeeze = x.dim() == 1
    vecs, (a, b) = _batch(x, (x, r, u, w, m, n_, z, q, s, p), alpha, beta)
    outs = pipecg_fused(*vecs, a, b)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs
