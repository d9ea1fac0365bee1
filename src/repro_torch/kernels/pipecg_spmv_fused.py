"""One whole Jacobi-PIPECG iteration in one sweep: wrappers + plain versions.

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

``pipecg_spmv_halo`` replaces the per-rank form
``repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_halo`` and launches the
same kernel: u and p read their rows outside [0, n) from the neighbours'
(k, 2h) strips, the operator (bands, diag^-1) carries the neighbours' h
rows on each side, and the row it returns is this rank's PARTIAL sum,
which the caller finishes with an all-reduce.

The accumulator dtype is x's; r, u, p and the operator (bands, diag^-1,
column sums) may be stored as bfloat16 or float8_e4m3fn.  Loads widen and
only the r', u', p' stores narrow.  The callers compute diag^-1 and the
column sums once per solve and pass them in.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.spmv_dia import spmv_dia_plain

NRED = 6  # <r,u>, <w,u>, <r,r>, <r,w>, <w,w>, ABFT 1^T(Au') - c^T u'


def _halo(offsets: Sequence[int]) -> int:
    return max(abs(int(o)) for o in offsets)


def _sweep_plain(offsets, bands, inv_diag, csum, x, r, u, p, alpha, beta,
                 rows: Optional[slice] = None) -> Tuple[torch.Tensor, ...]:
    """The sweep's arithmetic in plain torch over every row of x.

    ``rows`` selects the rows whose terms enter the reduction row (None:
    all), as the kernel's ``n_valid`` mask does.
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
    rs, us, ws, cs = r2, u2, w2, csum.to(acc)
    if rows is not None:
        rs, us, ws, cs = rs[:, rows], us[:, rows], ws[:, rows], cs[rows]
    red = torch.stack([
        torch.sum(rs * us, dim=-1), torch.sum(ws * us, dim=-1),
        torch.sum(rs * rs, dim=-1), torch.sum(rs * ws, dim=-1),
        torch.sum(ws * ws, dim=-1),
        torch.sum(ws, dim=-1) - torch.sum(cs * us, dim=-1)],
        dim=-1)
    return x2, r2.to(r.dtype), u2.to(u.dtype), p2.to(p.dtype), red


def pipecg_spmv_fused_plain(offsets: Sequence[int], bands, inv_diag, csum,
                            x, r, u, p, alpha, beta
                            ) -> Tuple[torch.Tensor, ...]:
    """The sweep in plain torch, term for term as the reference oracle.

    x/r/u/p (k, n), alpha/beta (k,), bands (n_bands, n), inv_diag and
    csum (n,).  Returns (x', r', u', p', red (k, 6)).
    """
    return _sweep_plain(offsets, bands, inv_diag, csum, x, r, u, p,
                        alpha, beta)


def pipecg_spmv_halo_plain(offsets: Sequence[int], bands_ext, invd_ext, csum,
                           x, r, u, p, u_lo, u_hi, p_lo, p_hi, alpha, beta
                           ) -> Tuple[torch.Tensor, ...]:
    """The per-rank sweep in plain torch.

    Extends the vectors by 2h rows each side with the strips (x and r with
    zeros; they are only read on local rows) and the operator by h more
    zero rows, runs the sweep's arithmetic over the extended rows, and
    keeps the local rows [2h, 2h + n) of the vectors and of the partials.
    """
    h = _halo(offsets)
    n = x.shape[-1]

    def pad(v, w):
        z = torch.zeros(v.shape[:-1] + (w,), dtype=v.dtype, device=v.device)
        return torch.cat([z, v, z], dim=-1)

    local = slice(2 * h, 2 * h + n)
    outs = _sweep_plain(offsets, pad(bands_ext, h), pad(invd_ext, h),
                        pad(csum, 2 * h), pad(x, 2 * h), pad(r, 2 * h),
                        torch.cat([u_lo, u, u_hi], dim=-1),
                        torch.cat([p_lo, p, p_hi], dim=-1), alpha, beta,
                        rows=local)
    return tuple(o[:, local] for o in outs[:4]) + (outs[4],)


def _launch(name: str, offsets, bands, inv_diag, csum, x, r, u, p, alpha,
            beta, oext: int, strips=None) -> Tuple[torch.Tensor, ...]:
    """Check the operands and launch the sweep kernel on x's device.

    ``bands`` (n_bands, n + 2 oext) and ``inv_diag`` (n + 2 oext,) hold the
    operator rows [-oext, n + oext); ``strips`` is None (zero outside
    [0, n)) or (u_lo, u_hi, p_lo, p_hi), each (k, 2h).
    """
    k, n = x.shape
    nb = len(offsets)
    if not 1 <= nb <= _b.MAX_BANDS:
        raise ValueError(f"{name}: {nb} bands, the kernel takes 1.."
                         f"{_b.MAX_BANDS}")
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: x must be float32 or float64")
    h = _halo(offsets)
    sto = r.dtype
    ld = n + 2 * oext
    shapes = [("r", r, (k, n), sto), ("u", u, (k, n), sto),
              ("p", p, (k, n), sto), ("bands", bands, (nb, ld), sto),
              ("inv_diag", inv_diag, (ld,), sto), ("csum", csum, (n,), sto),
              ("alpha", alpha, (k,), x.dtype), ("beta", beta, (k,), x.dtype)]
    if strips is not None:
        shapes += [(key, t, (k, 2 * h), sto) for key, t in
                   zip(("u_lo", "u_hi", "p_lo", "p_hi"), strips)]
    for key, t, shape, dt in shapes:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dt}")
    _b.check_cuda(name, x.device, x=x, **{key: t for key, t, _, _ in shapes})
    nblk = -(-n // _b.BLOCK)
    xo, ro, uo, po = (torch.empty_like(v) for v in (x, r, u, p))
    partials = torch.empty((k, nblk, NRED), dtype=x.dtype, device=x.device)
    red = torch.empty((k, NRED), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    P = _b.ptr
    lo_hi = [P(t) for t in strips] if strips is not None else [None] * 4
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipecg_spmv_fused(
            _b.dtype_code(name, x), _b.dtype_code(name, r), offs, nb, n, k,
            P(bands), P(inv_diag), oext, P(csum),
            P(x), P(r), P(u), P(p),
            *lo_hi, 2 * h, n,
            P(alpha), P(beta), P(xo), P(ro), P(uo), P(po),
            P(partials), nblk, P(red), _b.stream_of(x.device))
    _b.raise_on_error(name, rc)
    return xo, ro, uo, po, red


def _on_cpu(name: str, x, *tensors) -> bool:
    """True for CPU operands; raises for mixed devices or no kernel."""
    if x.device.type == "cpu":
        for t in tensors:
            if t.device != x.device:
                raise ValueError(f"{name}: operands on {t.device} and cpu")
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return False


def pipecg_spmv_fused(offsets: Sequence[int], bands, inv_diag, csum,
                      x, r, u, p, alpha, beta) -> Tuple[torch.Tensor, ...]:
    """One fused PIPECG iteration for k right-hand sides (see module doc).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`pipecg_spmv_fused_plain`.  ``pipecg_spmv_fused.launches``
    counts kernel launches.
    """
    if _on_cpu("pipecg_spmv_fused", x, bands, inv_diag, csum, r, u, p,
               alpha, beta):
        return pipecg_spmv_fused_plain(offsets, bands, inv_diag, csum,
                                       x, r, u, p, alpha, beta)
    outs = _launch("pipecg_spmv_fused", offsets, bands, inv_diag, csum,
                   x, r, u, p, alpha, beta, oext=0)
    pipecg_spmv_fused.launches += 1
    return outs


def pipecg_spmv_halo(offsets: Sequence[int], bands_ext, invd_ext, csum,
                     x, r, u, p, u_lo, u_hi, p_lo, p_hi, alpha, beta
                     ) -> Tuple[torch.Tensor, ...]:
    """One rank's fused PIPECG iteration with its neighbours' rows.

    x/r/u/p (k, n) local rows; u_lo/u_hi/p_lo/p_hi (k, 2h) the rows
    [-2h, 0) and [n, n + 2h) (zeros at the ends of the chain); bands_ext
    (n_bands, n + 2h) and invd_ext (n + 2h,) the operator rows [-h, n + h);
    csum (n,) this rank's slice of the global c = A^T 1.  Returns
    (x', r', u', p', red) with red (k, 6) this rank's partial row.

    CUDA tensors launch the sweep kernel (or raise); CPU tensors take
    :func:`pipecg_spmv_halo_plain`.  ``pipecg_spmv_halo.launches`` counts
    kernel launches.
    """
    strips = (u_lo, u_hi, p_lo, p_hi)
    if _on_cpu("pipecg_spmv_halo", x, bands_ext, invd_ext, csum, r, u, p,
               alpha, beta, *strips):
        return pipecg_spmv_halo_plain(offsets, bands_ext, invd_ext, csum,
                                      x, r, u, p, *strips, alpha, beta)
    outs = _launch("pipecg_spmv_halo", offsets, bands_ext, invd_ext, csum,
                   x, r, u, p, alpha, beta, oext=_halo(offsets),
                   strips=strips)
    pipecg_spmv_halo.launches += 1
    return outs


pipecg_spmv_fused.launches = 0
pipecg_spmv_halo.launches = 0
