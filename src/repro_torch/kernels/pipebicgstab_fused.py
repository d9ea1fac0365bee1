"""One whole pipelined BiCGStab iteration in one sweep: wrappers + plain versions.

``pipebicgstab_fused`` replaces the Pallas TPU kernel
``repro/kernels/pipebicgstab_fused.py::pipebicgstab_fused``.  Given the
three scalars alpha, beta and omega of
``core/krylov/bicgstab.py::pbicgstab_scalars`` it computes

    p  = r + beta pa          s  = w + beta a        z  = t + beta c
    v  = A z
    q  = r - alpha s          y  = w - alpha z
    x' = x + alpha p + omega q
    r' = q - omega y          w' = y - omega (t - alpha v)
    t' = A w'
    pa' = p - omega s         a' = s - omega z       c' = z - omega v

and the (7, 6) payload: rows 0..5 the Gram matrix of
``[r', w', t', a', c', r_hat]``, and ``gram[6, 0]`` the ABFT checksum
residual ``1^T t' - c^T w'`` of the second SpMV (``c = A^T 1``).  Its
kernel (csrc/pipebicgstab_fused.cu) is bound by bytes on the H100:
(16 + n_bands) words per row, 19n for a tridiagonal operator.  Each
CTA forms its rows' ``z -> v -> w' -> t'`` chain once per row over
shared-memory row windows (``pipecg_spmv_fused.window_plan``), writes
fresh output buffers, and the CTAs finish the Gram in a fixed order in
the same launch, with integer tickets (no second kernel, no float
atomics).

``pipebicgstab_halo`` replaces the per-rank form
``repro/kernels/pipebicgstab_fused.py::pipebicgstab_halo`` and launches
the same kernel: w, t and c read their rows outside [0, n) from the
neighbours' (2h,) strips, the bands carry the neighbours' h rows on each
side, and the payload it returns is this rank's PARTIAL sum, which the
caller finishes with an all-reduce.

x, the scalars, the column sums ``c`` and the payload are at the
accumulator dtype (float64 or float32); the chains r, w, t, pa, a, c,
r_hat and the bands may be stored as bfloat16 or float8_e4m3fn.  Loads
widen, and only the six chain stores narrow; r_hat is only read.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.pipecg_spmv_fused import (_halo, _on_cpu,
                                                   device_plan, finish_groups,
                                                   tickets, window_plan)
from repro_torch.kernels.spmv_dia import spmv_dia_plain

NBASIS = 6                 # Gram basis [r', w', t', a', c', r_hat]
NGRAM = NBASIS + 1         # + the ABFT checksum row
NPART = 22                 # 21 unique Gram entries + the checksum partial
#: the most rows per CTA of the sweep and the shared memory a CTA keeps
#: within (its 23 accumulators hold it to two CTAs an SM at float64)
BICG_TILE = 2048
BICG_SMEM_TARGET = 96 * 1024


def sweep_plan(offsets: Sequence[int], acc_bytes: int,
               max_tile: int = None) -> Tuple[int, List[int], int]:
    """The sweep's row-window plan (``pipecg_spmv_fused.window_plan``:
    three own-row arrays, r', a', c', tiles up to ``max_tile``, default
    ``BICG_TILE``; the autotuner's cap, kernels/autotune.py)."""
    return window_plan(offsets, acc_bytes, 3,
                       BICG_TILE if max_tile is None else max_tile,
                       BICG_SMEM_TARGET)


def _sweep_plain(offsets, bands, csum, x, r, w, t, pa, a, c, r_hat,
                 alpha, beta, omega, rows: Optional[slice] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The sweep's arithmetic in plain torch over every row of x.

    ``rows`` selects the rows whose terms enter the payload (None: all),
    as the kernel's ``n_valid`` mask does.
    """
    acc = x.dtype
    al, be, om = (torch.as_tensor(s, dtype=acc, device=x.device)
                  for s in (alpha, beta, omega))
    bands_a = bands.to(acc)
    r_a, w_a, t_a, pa_a, a_a, c_a, rh_a = (
        v.to(acc) for v in (r, w, t, pa, a, c, r_hat))
    p = r_a + be * pa_a
    s = w_a + be * a_a
    z = t_a + be * c_a
    v = spmv_dia_plain(offsets, bands_a, z)
    q = r_a - al * s
    y = w_a - al * z
    x2 = x + al * p + om * q
    r2 = q - om * y
    w2 = y - om * (t_a - al * v)
    t2 = spmv_dia_plain(offsets, bands_a, w2)
    pa2 = p - om * s
    a2 = s - om * z
    c2 = z - om * v
    C = torch.stack([r2, w2, t2, a2, c2, rh_a])
    cs = csum.to(acc)
    if rows is not None:
        C, cs = C[:, rows], cs[rows]
    chk = torch.sum(C[2]) - torch.sum(cs * C[1])
    gram = torch.cat([C @ C.T, torch.zeros((1, NBASIS), dtype=acc,
                                           device=x.device)])
    gram[NBASIS, 0] = chk
    outs = (x2, r2.to(r.dtype), w2.to(w.dtype), t2.to(t.dtype),
            pa2.to(pa.dtype), a2.to(a.dtype), c2.to(c.dtype))
    return outs + (gram,)


def pipebicgstab_fused_plain(offsets: Sequence[int], bands, csum,
                             x, r, w, t, pa, a, c, r_hat,
                             alpha, beta, omega) -> Tuple[torch.Tensor, ...]:
    """The sweep in plain torch, term for term as the reference oracle.

    Vectors (n,), bands (n_bands, n), csum (n,) the column sums of the
    bands, alpha/beta/omega scalars.  Returns
    (x', r', w', t', pa', a', c', gram (7, 6)).
    """
    return _sweep_plain(offsets, bands, csum, x, r, w, t, pa, a, c, r_hat,
                        alpha, beta, omega)


def pipebicgstab_halo_plain(offsets: Sequence[int], bands_ext, csum,
                            x, r, w, t, pa, a, c, r_hat,
                            w_lo, w_hi, t_lo, t_hi, c_lo, c_hi,
                            alpha, beta, omega) -> Tuple[torch.Tensor, ...]:
    """The per-rank sweep in plain torch.

    Extends w, t and c by their (2h,) strips, the other vectors by 2h
    zeros each side and the operator by h more zero rows, runs the
    sweep's arithmetic over the extended rows, and keeps the local rows
    [2h, 2h + n) of the vectors and of the payload.
    """
    h = _halo(offsets)
    n = x.shape[-1]

    def pad(v, width):
        z = torch.zeros(v.shape[:-1] + (width,), dtype=v.dtype,
                        device=v.device)
        return torch.cat([z, v, z], dim=-1)

    local = slice(2 * h, 2 * h + n)
    outs = _sweep_plain(offsets, pad(bands_ext, h), pad(csum, 2 * h),
                        pad(x, 2 * h), pad(r, 2 * h),
                        torch.cat([w_lo, w, w_hi]),
                        torch.cat([t_lo, t, t_hi]),
                        pad(pa, 2 * h), pad(a, 2 * h),
                        torch.cat([c_lo, c, c_hi]), pad(r_hat, 2 * h),
                        alpha, beta, omega, rows=local)
    return tuple(o[local] for o in outs[:7]) + (outs[7],)


def _launch(name: str, offsets, bands, csum, x, r, w, t, pa, a, c, r_hat,
            alpha, beta, omega, oext: int, strips=None,
            n_valid: Optional[int] = None, max_tile: Optional[int] = None
            ) -> Tuple[torch.Tensor, ...]:
    """Check the operands and launch the sweep kernel on x's device.

    ``bands`` (n_bands, n + 2 oext) holds the operator rows
    [-oext, n + oext); ``strips`` is None (zero outside [0, n)) or
    (w_lo, w_hi, t_lo, t_hi, c_lo, c_hi), each (2h,).  Rows >= ``n_valid``
    (default n) stay out of the payload.  ``max_tile`` caps the CTA's
    tile (:func:`device_plan`; None: the autotuner's).
    """
    (n,) = x.shape
    nb = len(offsets)
    if not 1 <= nb <= _b.MAX_BANDS:
        raise ValueError(f"{name}: {nb} bands, the kernel takes 1.."
                         f"{_b.MAX_BANDS}")
    if x.dtype not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: x must be float32 or float64")
    h = _halo(offsets)
    acc, sto = x.dtype, r.dtype
    sc = [torch.as_tensor(s, dtype=acc, device=x.device).reshape(())
          .contiguous() for s in (alpha, beta, omega)]
    shapes = [(key, v, (n,), sto) for key, v in
              zip(("r", "w", "t", "pa", "a", "c", "r_hat"),
                  (r, w, t, pa, a, c, r_hat))]
    shapes += [("bands", bands, (nb, n + 2 * oext), sto),
               ("csum", csum, (n,), acc)]
    if strips is not None:
        shapes += [(key, s, (2 * h,), sto) for key, s in
                   zip(("w_lo", "w_hi", "t_lo", "t_hi", "c_lo", "c_hi"),
                       strips)]
    for key, v, shape, dt in shapes:
        if tuple(v.shape) != shape or v.dtype != dt:
            raise ValueError(f"{name}: {key} is {tuple(v.shape)} {v.dtype}, "
                             f"expected {shape} {dt}")
    _b.check_cuda(name, x.device, x=x, alpha=sc[0], beta=sc[1],
                  omega=sc[2], **{key: v for key, v, _, _ in shapes})
    tile, plan, smem = device_plan(sweep_plan, offsets, x, max_tile,
                                   None if sto == acc else sto)
    nblk = -(-n // tile)
    ngroups = finish_groups(nblk)
    outs = [torch.empty_like(v) for v in (x, r, w, t, pa, a, c)]
    partials = torch.empty((nblk + ngroups, NPART), dtype=acc,
                           device=x.device)
    gram = torch.empty((NGRAM, NBASIS), dtype=acc, device=x.device)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    P = _b.ptr
    lo_hi = [P(s) for s in strips] if strips is not None else [None] * 6
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipebicgstab_fused(
            _b.dtype_code(name, x), _b.dtype_code(name, r), offs, nb, n,
            P(bands), oext, P(csum),
            *(P(v) for v in (x, r, w, t, pa, a, c, r_hat)),
            *lo_hi, 2 * h, n if n_valid is None else n_valid,
            *(P(s) for s in sc),
            *(P(o) for o in outs), P(plan), plan.numel(), tile, smem,
            P(partials), nblk, P(tickets(x.device, ngroups + 1)), P(gram),
            _b.stream_of(x.device))
    _b.raise_on_error(name, rc)
    return tuple(outs) + (gram,)


def pipebicgstab_fused(offsets: Sequence[int], bands, csum,
                       x, r, w, t, pa, a, c, r_hat, alpha, beta, omega,
                       max_tile: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """One fused p-BiCGStab iteration on one device (see module doc).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors take
    :func:`pipebicgstab_fused_plain`.  ``max_tile`` caps the kernel's tile
    (None: the autotuner's, looked up when the sweep's plan is built;
    a probe passes its candidates).
    ``pipebicgstab_fused.launches`` counts kernel launches.
    """
    if _on_cpu("pipebicgstab_fused", x, bands, csum, r, w, t, pa, a, c,
               r_hat):
        return pipebicgstab_fused_plain(offsets, bands, csum, x, r, w, t,
                                        pa, a, c, r_hat, alpha, beta, omega)
    outs = _launch("pipebicgstab_fused", offsets, bands, csum, x, r, w, t,
                   pa, a, c, r_hat, alpha, beta, omega, oext=0,
                   max_tile=max_tile)
    pipebicgstab_fused.launches += 1
    return outs


def pipebicgstab_halo(offsets: Sequence[int], bands_ext, csum,
                      x, r, w, t, pa, a, c, r_hat,
                      w_lo, w_hi, t_lo, t_hi, c_lo, c_hi,
                      alpha, beta, omega, max_tile: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """One rank's fused p-BiCGStab iteration with its neighbours' rows.

    Vectors (n,) local rows; the strips (2h,) the rows [-2h, 0) and
    [n, n + 2h) of w, t and c (zeros at the ends of the chain); bands_ext
    (n_bands, n + 2h) the operator rows [-h, n + h); csum (n,) this
    rank's slice of the global ``c = A^T 1``.  Returns
    (x', r', w', t', pa', a', c', gram) with gram (7, 6) this rank's
    PARTIAL payload.

    CUDA tensors launch the sweep kernel (or raise); CPU tensors take
    :func:`pipebicgstab_halo_plain`.  ``max_tile`` as for
    :func:`pipebicgstab_fused`.  ``pipebicgstab_halo.launches`` counts
    kernel launches.
    """
    strips = (w_lo, w_hi, t_lo, t_hi, c_lo, c_hi)
    if _on_cpu("pipebicgstab_halo", x, bands_ext, csum, r, w, t, pa, a, c,
               r_hat, *strips):
        return pipebicgstab_halo_plain(offsets, bands_ext, csum, x, r, w, t,
                                       pa, a, c, r_hat, *strips,
                                       alpha, beta, omega)
    outs = _launch("pipebicgstab_halo", offsets, bands_ext, csum, x, r, w,
                   t, pa, a, c, r_hat, alpha, beta, omega,
                   oext=_halo(offsets), strips=strips, max_tile=max_tile)
    pipebicgstab_halo.launches += 1
    return outs


pipebicgstab_fused.launches = 0
pipebicgstab_halo.launches = 0
