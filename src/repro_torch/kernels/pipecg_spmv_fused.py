"""One whole Jacobi-PIPECG iteration in one sweep: wrapper + plain version.

``pipecg_spmv_fused`` replaces the Pallas TPU kernel
``repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_fused``.  Per right-hand
side it computes p' = u + beta p, s' = A p', q' = diag^-1 s',
x' = x + alpha p', r' = r - alpha s', u' = u - alpha q', w' = A u' and the
(k, 6) reduction row (<r',u'>, <w',u'>, <r',r'>, <r',w'>, <w',w'>,
1^T w' - c^T u').  Its kernel (csrc/pipecg_spmv_fused.cu) is bound by bytes
on the H100: (10 + n_bands) words per row, 13n for the tridiagonal
operator, with s, q and w never stored.  It recomputes each row's
neighbour chain from device memory instead of padded copies, writes fresh
output buffers, and finishes its sums in a fixed-order second pass.

The accumulator dtype is x's; r, u, p and the operator (bands, diag^-1,
column sums) may be stored as bfloat16 or float8_e4m3fn.  Loads widen and
only the r', u', p' stores narrow.  The engine computes diag^-1 and the
column sums once per solve and passes them in.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.spmv_dia import spmv_dia_plain

NRED = 6  # <r,u>, <w,u>, <r,r>, <r,w>, <w,w>, ABFT 1^T(Au') - c^T u'


def pipecg_spmv_fused_plain(offsets: Sequence[int], bands, inv_diag, csum,
                            x, r, u, p, alpha, beta
                            ) -> Tuple[torch.Tensor, ...]:
    """The sweep in plain torch, term for term as the reference oracle.

    x/r/u/p (k, n), alpha/beta (k,), bands (n_bands, n), inv_diag and
    csum (n,).  Returns (x', r', u', p', red (k, 6)).
    """
    acc = x.dtype
    a = alpha.to(acc)[:, None]
    b = beta.to(acc)[:, None]
    bands_a = bands.to(acc)
    r_a, u_a, p_a = (v.to(acc) for v in (r, u, p))
    p2 = u_a + b * p_a
    s2 = spmv_dia_plain(offsets, bands_a, p2)
    q2 = inv_diag.to(acc) * s2
    x2 = x + a * p2
    r2 = r_a - a * s2
    u2 = u_a - a * q2
    w2 = spmv_dia_plain(offsets, bands_a, u2)
    red = torch.stack([
        torch.sum(r2 * u2, dim=-1), torch.sum(w2 * u2, dim=-1),
        torch.sum(r2 * r2, dim=-1), torch.sum(r2 * w2, dim=-1),
        torch.sum(w2 * w2, dim=-1),
        torch.sum(w2, dim=-1) - torch.sum(csum.to(acc) * u2, dim=-1)],
        dim=-1)
    return x2, r2.to(r.dtype), u2.to(u.dtype), p2.to(p.dtype), red


def pipecg_spmv_fused(offsets: Sequence[int], bands, inv_diag, csum,
                      x, r, u, p, alpha, beta) -> Tuple[torch.Tensor, ...]:
    """One fused PIPECG iteration for k right-hand sides (see module doc).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`pipecg_spmv_fused_plain`.  ``pipecg_spmv_fused.launches``
    counts kernel launches.
    """
    if x.device.type == "cpu":
        for t in (bands, inv_diag, csum, r, u, p, alpha, beta):
            if t.device != x.device:
                raise ValueError("pipecg_spmv_fused: operands on "
                                 f"{t.device} and cpu")
        return pipecg_spmv_fused_plain(offsets, bands, inv_diag, csum,
                                       x, r, u, p, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"pipecg_spmv_fused: no kernel for {x.device}")
    name = "pipecg_spmv_fused"
    k, n = x.shape
    nb = len(offsets)
    if not 1 <= nb <= _b.MAX_BANDS:
        raise ValueError(f"{name}: {nb} bands, the kernel takes 1.."
                         f"{_b.MAX_BANDS}")
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: x must be float32 or float64")
    sto = r.dtype
    for key, t, shape, dt in (
            ("r", r, (k, n), sto), ("u", u, (k, n), sto),
            ("p", p, (k, n), sto), ("bands", bands, (nb, n), sto),
            ("inv_diag", inv_diag, (n,), sto), ("csum", csum, (n,), sto),
            ("alpha", alpha, (k,), x.dtype), ("beta", beta, (k,), x.dtype)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dt}")
    _b.check_cuda(name, x.device, bands=bands, inv_diag=inv_diag, csum=csum,
                  x=x, r=r, u=u, p=p, alpha=alpha, beta=beta)
    h = max(abs(int(o)) for o in offsets)
    nblk = -(-n // _b.BLOCK)
    xo, ro, uo, po = (torch.empty_like(v) for v in (x, r, u, p))
    partials = torch.empty((k, nblk, NRED), dtype=x.dtype, device=x.device)
    red = torch.empty((k, NRED), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    P = _b.ptr
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipecg_spmv_fused(
            _b.dtype_code(name, x), _b.dtype_code(name, r), offs, nb, n, k,
            P(bands), P(inv_diag), P(csum),
            P(x), P(r), P(u), P(p),
            None, None, None, None, 2 * h, n,
            P(alpha), P(beta), P(xo), P(ro), P(uo), P(po),
            P(partials), nblk, P(red), _b.stream_of(x.device))
    _b.raise_on_error(name, rc)
    pipecg_spmv_fused.launches += 1
    return xo, ro, uo, po, red


pipecg_spmv_fused.launches = 0
