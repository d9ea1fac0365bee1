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

from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.fused_dots import fused_dots as _fused_dots
from repro_torch.kernels.pipebicgstab_fused import (pipebicgstab_fused,
                                                    pipebicgstab_halo)
from repro_torch.kernels.pipecg_fused import pipecg_fused
from repro_torch.kernels.pipecg_spmv_fused import (ghost_chain_fused,
                                                   ghost_chain_halo,
                                                   pipecg_spmv_fused,
                                                   pipecg_spmv_halo)
from repro_torch.kernels.spmv_bsr import pipecg_bsr_fused, spmv_bsr
from repro_torch.kernels.spmv_dia import spmv_dia, spmv_dia_ext
from repro_torch.kernels.wkv import wkv_recurrent as _wkv_recurrent

#: every kernel wrapper of the package, by kernel name
KERNELS = {
    "spmv_dia": spmv_dia,
    "spmv_dia_ext": spmv_dia_ext,
    "pipecg_spmv_fused": pipecg_spmv_fused,
    "pipecg_spmv_halo": pipecg_spmv_halo,
    "pipecg_fused": pipecg_fused,
    "fused_dots": _fused_dots,
    "pipebicgstab_fused": pipebicgstab_fused,
    "pipebicgstab_halo": pipebicgstab_halo,
    "ghost_chain_fused": ghost_chain_fused,
    "ghost_chain_halo": ghost_chain_halo,
    "spmv_bsr": spmv_bsr,
    "pipecg_bsr_fused": pipecg_bsr_fused,
    "flash_attention": flash_attention,
    "wkv_recurrent": _wkv_recurrent,
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


def spmv_dia_ext_step(offsets: Sequence[int], bands, x_ext, halo: int
                      ) -> torch.Tensor:
    """Banded SpMV of a rank's rows on its halo-extended x_ext (n + 2h,)
    or (k, n + 2h) (kernel-backed on CUDA)."""
    return spmv_dia_ext(tuple(offsets), bands.contiguous(),
                        x_ext.contiguous(), int(halo))


def spmv_bsr_step(indices, blocks, x) -> torch.Tensor:
    """Blocked-ELL SpMV for x (n,) or (k, n) (kernel-backed on CUDA)."""
    return spmv_bsr(indices, blocks, x.contiguous())


def fused_dots(V, z) -> torch.Tensor:
    """One-pass multi-dot ``V @ z`` for V (m, n), z (n,) (kernel-backed)."""
    return _fused_dots(V.contiguous(), z.contiguous())


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


def pipecg_bsr_fused_step(indices, blocks, inv_diag, csum, x, r, u, p,
                          alpha, beta) -> Tuple[torch.Tensor, ...]:
    """Single-sweep PIPECG iteration on a BSR operator: the contract of
    :func:`pipecg_spmv_fused_step` (the same (k, 6) reduction row)."""
    squeeze = x.dim() == 1
    (x2, r2, u2, p2), (a, b) = _batch(x, (x, r, u, p), alpha, beta)
    outs = pipecg_bsr_fused(indices, blocks, inv_diag, csum,
                            x2, r2, u2, p2, a, b)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs


def pipecg_spmv_halo_step(offsets: Sequence[int], bands_ext, invd_ext, csum,
                          x, r, u, p, u_lo, u_hi, p_lo, p_hi, alpha, beta
                          ) -> Tuple[torch.Tensor, ...]:
    """One rank's single-sweep PIPECG iteration with neighbour strips.

    Vectors (n,) or (k, n) local rows, strips (2h,) or (k, 2h); returns
    (x', r', u', p', red) with red this rank's PARTIAL reduction row.
    """
    squeeze = x.dim() == 1
    vecs, (a, b) = _batch(x, (x, r, u, p, u_lo, u_hi, p_lo, p_hi),
                          alpha, beta)
    outs = pipecg_spmv_halo(tuple(offsets), bands_ext, invd_ext, csum,
                            *vecs, a, b)
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


def pipebicgstab_fused_step(offsets: Sequence[int], bands, csum,
                            x, r, w, t, pa, a, c, r_hat, alpha, beta, omega
                            ) -> Tuple[torch.Tensor, ...]:
    """Single-sweep p-BiCGStab iteration (9 updates + 2 SpMVs + Gram).

    Vectors (n,), 0-d alpha/beta/omega; returns
    (x', r', w', t', pa', a', c', gram (7, 6)).
    """
    vecs = tuple(v.contiguous() for v in (x, r, w, t, pa, a, c, r_hat))
    return pipebicgstab_fused(tuple(offsets), bands, csum, *vecs,
                              alpha, beta, omega)


def pipebicgstab_halo_step(offsets: Sequence[int], bands_ext, csum,
                           x, r, w, t, pa, a, c, r_hat,
                           w_lo, w_hi, t_lo, t_hi, c_lo, c_hi,
                           alpha, beta, omega) -> Tuple[torch.Tensor, ...]:
    """One rank's single-sweep p-BiCGStab iteration with neighbour strips.

    Vectors (n,) local rows, strips (2h,); returns the vectors and this
    rank's PARTIAL (7, 6) payload.
    """
    vecs = tuple(v.contiguous() for v in
                 (x, r, w, t, pa, a, c, r_hat,
                  w_lo, w_hi, t_lo, t_hi, c_lo, c_hi))
    return pipebicgstab_halo(tuple(offsets), bands_ext, csum, *vecs,
                             alpha, beta, omega)


def ghost_chain_step(offsets: Sequence[int], bands, p, r, theta, l: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-l ghost basis + Gram in one sweep (kernel-backed on CUDA).

    Returns ``(chain, gram)``: the (2l+1, n) theta-scaled basis
    [p, A~p, .., A~^l p, r, .., A~^(l-1) r] and its (2l+1, 2l+1) Gram
    matrix, the one reduction of a depth-l block.
    """
    return ghost_chain_fused(tuple(offsets), bands, p.contiguous(),
                             r.contiguous(), theta, l)


def ghost_chain_halo_step(offsets: Sequence[int], bands_ext, p, r, p_left,
                          p_right, r_left, r_right, theta, l: int,
                          accum_dtype=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's depth-l ghost-chain sweep with neighbour strips.

    The strips are (l*h,), exchanged once per block; ``bands_ext`` is the
    once-per-solve l*h-extended operator.  The returned ``gram`` is this
    rank's PARTIAL Gram (the caller all-reduces it).
    """
    n = p.shape[-1]
    H = l * max(abs(int(o)) for o in offsets)
    if n < 2 * H:
        raise ValueError(
            f"local shard of {n} rows is narrower than the 2*l*halo={2 * H} "
            "chain reach; use fewer ranks or a smaller depth")
    vecs = tuple(v.contiguous() for v in (p, r, p_left, p_right, r_left,
                                          r_right))
    return ghost_chain_halo(tuple(offsets), bands_ext, *vecs, theta, l,
                            accum_dtype)


def flash_mha(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention forward on (BH, S, D) q/k/v (kernel-backed on
    CUDA).  The kernel masks the ragged S edge itself: nothing pads."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal)


def wkv_recurrent(r, k, v, logw, u) -> torch.Tensor:
    """Exact RWKV-6 recurrence on (BH, T, D) inputs and (BH, D) u; returns
    (BH, T, D) float32 (kernel-backed on CUDA)."""
    return _wkv_recurrent(*(t.contiguous() for t in (r, k, v, logw, u)))
