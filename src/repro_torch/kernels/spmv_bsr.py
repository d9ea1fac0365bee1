"""Blocked-ELL (BSR) SpMV and one-sweep PIPECG: wrappers + plain versions.

``spmv_bsr`` replaces the Pallas TPU kernel
``repro/kernels/spmv_bsr.py::spmv_bsr``: ``y[br] = sum_d blocks[br, d] @
x[indices[br, d]]`` for x (n,) or (k, n).  Its kernel (csrc/spmv_bsr.cu)
is bound by bytes on the H100: per row deg*bs block values, deg/bs int32
indices, one x read and one y write (22.75 words for ex23 at bs = 4).

``pipecg_bsr_fused`` replaces ``repro/kernels/spmv_bsr.py::
pipecg_bsr_fused``: one whole Jacobi-preconditioned PIPECG iteration on a
BSR operator, p' = u + beta p, s' = A p', q' = diag^-1 s', x' = x + alpha
p', r' = r - alpha s', u' = u - alpha q', w' = A u' and the (k, 6)
reduction row of the DIA sweep (<r',u'>, <w',u'>, <r',r'>, <r',w'>,
<w',w'>, 1^T w' - c^T u'), storing only x, r, u and p.  Bound by bytes:
10 vectors + blocks + indices per row (``BsrMatrix.words_per_iter``).
Its kernel computes u' once per row into a shared-memory tile of the
CTA's block rows and forms w' = A u' from it; a block column outside that
range (the two-level gather ``indices[indices[br]]``) has u' recomputed
and swapped across the bs lanes of a block row by warp shuffle, so bs
must be a power of two up to 32.  Blocks, u and p are read by 16-byte
loads and must start on 16-byte boundaries.

Both take float32 or float64, the operator at x's dtype: the JAX package
never demotes a BSR operator.  The plain versions add the terms in the
kernels' order (loops over d, then the block column c, from zero), so on
the card the vectors agree bit for bit and the partials, summed in
another order, to rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.pipecg_spmv_fused import NRED, _on_cpu


def spmv_bsr_plain(indices, blocks, x) -> torch.Tensor:
    """``y = A x`` in plain torch, term for term as the kernel adds them.

    ``indices`` (nbr, deg) int32, ``blocks`` (nbr, deg, bs, bs) (widened to
    x's dtype), ``x`` (n,) or (k, n) with n = nbr * bs.
    """
    nbr, deg = indices.shape
    bs = blocks.shape[-1]
    blk = blocks.to(x.dtype)
    g = x.reshape(x.shape[:-1] + (nbr, bs))[..., indices.long(), :]
    y = torch.zeros(x.shape[:-1] + (nbr, bs), dtype=x.dtype,
                    device=x.device)
    for d in range(deg):
        for c in range(bs):
            y = y + blk[:, d, :, c] * g[..., d, c, None]
    return y.reshape(x.shape)


def pipecg_bsr_fused_plain(indices, blocks, inv_diag, csum, x, r, u, p,
                           alpha, beta) -> Tuple[torch.Tensor, ...]:
    """The sweep in plain torch, in the kernel's evaluation order.

    x/r/u/p (k, n), alpha/beta (k,), inv_diag and csum (n,).  Returns
    (x', r', u', p', red (k, 6)).
    """
    a = alpha[:, None]
    b = beta[:, None]
    p2 = u + b * p
    s2 = spmv_bsr_plain(indices, blocks, p2)
    x2 = x + a * p2
    r2 = r - a * s2
    u2 = u - a * (inv_diag * s2)
    w2 = spmv_bsr_plain(indices, blocks, u2)
    red = torch.stack([
        torch.sum(r2 * u2, dim=-1), torch.sum(w2 * u2, dim=-1),
        torch.sum(r2 * r2, dim=-1), torch.sum(r2 * w2, dim=-1),
        torch.sum(w2 * w2, dim=-1),
        torch.sum(w2, dim=-1) - torch.sum(csum * u2, dim=-1)], dim=-1)
    return x2, r2, u2, p2, red


def _check(name: str, indices, blocks, x, extra=()) -> Tuple[int, int, int]:
    """Check the operands of a launch; returns (nbr, deg, bs)."""
    nbr, deg = indices.shape
    bs = blocks.shape[-1]
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: x must be float32 or float64, got "
                         f"{x.dtype}")
    if indices.dtype != torch.int32 or tuple(blocks.shape) != (
            nbr, deg, bs, bs) or x.shape[-1] != nbr * bs:
        raise ValueError(f"{name}: indices {tuple(indices.shape)} "
                         f"{indices.dtype}, blocks {tuple(blocks.shape)} and "
                         f"x {tuple(x.shape)} do not fit")
    for key, t in (("blocks", blocks),) + tuple(extra):
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected "
                             f"{x.dtype}")
    _b.check_cuda(name, x.device, indices=indices, blocks=blocks, x=x,
                  **dict(extra))
    return nbr, deg, bs


def spmv_bsr(indices, blocks, x) -> torch.Tensor:
    """Blocked-ELL SpMV ``y = A x`` for x (n,) or (k, n).

    A CUDA ``x`` launches the CUDA kernel (or raises); a CPU ``x`` takes
    :func:`spmv_bsr_plain`.  ``indices`` must name block rows (a
    ``BsrMatrix`` checks that when it is built).  ``spmv_bsr.launches``
    counts kernel launches.
    """
    if _on_cpu("spmv_bsr", x, indices, blocks):
        return spmv_bsr_plain(indices, blocks, x)
    if x.dim() not in (1, 2):
        raise ValueError(f"spmv_bsr: x must be (n,) or (k, n), got "
                         f"{tuple(x.shape)}")
    nbr, deg, bs = _check("spmv_bsr", indices, blocks, x)
    k = 1 if x.dim() == 1 else x.shape[0]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_spmv_bsr(
            _b.dtype_code("spmv_bsr", x), nbr, deg, bs, k, _b.ptr(indices),
            _b.ptr(blocks), _b.ptr(x), _b.ptr(y), _b.stream_of(x.device))
    _b.raise_on_error("spmv_bsr", rc)
    spmv_bsr.launches += 1
    return y


spmv_bsr.launches = 0


def pipecg_bsr_fused(indices, blocks, inv_diag, csum, x, r, u, p, alpha,
                     beta) -> Tuple[torch.Tensor, ...]:
    """One fused PIPECG iteration on a BSR operator for k right-hand sides.

    x/r/u/p (k, n), alpha/beta (k,), inv_diag and csum (n,), all at one
    dtype.  CUDA tensors launch the CUDA kernel (or raise); CPU tensors
    take :func:`pipecg_bsr_fused_plain`.  ``pipecg_bsr_fused.launches``
    counts kernel launches.
    """
    name = "pipecg_bsr_fused"
    if _on_cpu(name, x, indices, blocks, inv_diag, csum, r, u, p, alpha,
               beta):
        return pipecg_bsr_fused_plain(indices, blocks, inv_diag, csum,
                                      x, r, u, p, alpha, beta)
    k, n = x.shape
    vecs = (("r", r, (k, n)), ("u", u, (k, n)), ("p", p, (k, n)),
            ("inv_diag", inv_diag, (n,)), ("csum", csum, (n,)),
            ("alpha", alpha, (k,)), ("beta", beta, (k,)))
    for key, t, shape in vecs:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                             f"{shape}")
    nbr, deg, bs = _check(name, indices, blocks, x,
                          tuple((key, t) for key, t, _ in vecs))
    if bs > 32 or bs & (bs - 1):
        raise ValueError(f"{name}: block size {bs}; the kernel swaps a block "
                         "row's values across bs lanes of a warp, so bs "
                         "must be a power of two up to 32")
    for key, t in (("blocks", blocks), ("u", u), ("p", p)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (the kernel reads it in 16-byte "
                             "loads)")
    nblk = -(-n // _b.BLOCK)
    xo, ro, uo, po = (torch.empty_like(v) for v in (x, r, u, p))
    partials = torch.empty((k, nblk, NRED), dtype=x.dtype, device=x.device)
    red = torch.empty((k, NRED), dtype=x.dtype, device=x.device)
    P = _b.ptr
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipecg_bsr_fused(
            _b.dtype_code(name, x), nbr, deg, bs, k, P(indices), P(blocks),
            P(inv_diag), P(csum), P(x), P(r), P(u), P(p), P(alpha), P(beta),
            P(xo), P(ro), P(uo), P(po), P(partials), nblk, P(red),
            _b.stream_of(x.device))
    _b.raise_on_error(name, rc)
    pipecg_bsr_fused.launches += 1
    return xo, ro, uo, po, red


pipecg_bsr_fused.launches = 0
