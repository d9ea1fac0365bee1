"""One whole Jacobi-PIPECG iteration in one sweep: wrappers + plain versions.

``pipecg_spmv_fused`` replaces the Pallas TPU kernel
``repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_fused``.  Per right-hand
side it computes p' = u + beta p, s' = A p', q' = diag^-1 s',
x' = x + alpha p', r' = r - alpha s', u' = u - alpha q', w' = A u' and the
(k, 6) reduction row (<r',u'>, <w',u'>, <r',r'>, <r',w'>, <w',w'>,
1^T w' - c^T u').  Its kernel (csrc/pipecg_spmv_fused.cu) is bound by bytes
on the H100: (10 + n_bands) words per row, 13n for the tridiagonal
operator, with s, q and w never stored.  Each CTA forms p', then s' and
u', once per row over shared-memory row windows around its tile
(:func:`window_plan` sizes them; far bands such as the 2-D Laplacian's
+-nx get tile-sized clusters of their own), writes fresh output buffers,
and the CTAs finish the sums in a fixed order in the same launch, with
integer tickets (no second kernel, no float atomics).

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

``ghost_chain_fused`` replaces ``repro/kernels/pipecg_spmv_fused.py::
ghost_chain_fused``, the depth-l sweep: with ``A~ = A / theta`` it returns
the (2l+1, n) ghost basis ``C = [p, A~p, .., A~^l p, r, A~r, ..,
A~^(l-1) r]`` and its (2l+1, 2l+1) Gram matrix ``C C^T``, the one
reduction of a depth-l block (core/krylov/pipeline.py).  Its kernel
(csrc/ghost_chain.cu) is bound by bytes: 2 + n_bands + 2l + 1 words per
row, 10n for the tridiagonal operator at l = 2.  ``ghost_chain_halo``
replaces the per-rank form ``::ghost_chain_halo`` and launches the same
kernel with the neighbours' (l*h,) strips of p and r and the operator
rows [-l*h, n + l*h); its Gram is this rank's PARTIAL sum.  Links and
Gram run at the accumulator dtype; p, r, the bands and C may be stored
narrower, and the Gram is taken before C's store narrows it.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.spmv_dia import spmv_dia_plain

NRED = 6  # <r,u>, <w,u>, <r,r>, <r,w>, <w,w>, ABFT 1^T(Au') - c^T u'
#: rows per CTA of the ghost-chain sweep (twice that for a wide reach)
CHAIN_TILE = 1024
#: the most rows per CTA of the PIPECG sweep, and the shared memory a CTA
#: keeps within where a tile of 32 rows or more allows it (four CTAs of
#: at most 64 registers a thread share an SM)
SWEEP_TILE = 1024
SWEEP_SMEM_TARGET = 48 * 1024
#: the most a sweep CTA may take: the 227 KB a CTA may opt into, less the
#: kernels' static block-reduction buffers (23 + 22 float64 columns of 32
#: warps)
SWEEP_SMEM_LIMIT = 232_448 - 16_384
#: window slots a sweep CTA takes at once (kBatch * kBlock in
#: csrc/common.cuh), and the batches a CTA's set-up and sums cost besides
SWEEP_STEP = 4 * 256
SWEEP_FIXED = 2
#: CTAs per group of the sweeps' two-level finish (kGroup in
#: csrc/common.cuh): a launch of nblk CTAs writes nblk + ceil(nblk / 32)
#: partial rows and takes ceil(nblk / 32) + 1 tickets
FINISH_GROUP = 32


def _halo(offsets: Sequence[int]) -> int:
    return max(abs(int(o)) for o in offsets)


def _clusters(shifts, tile: int) -> List[Tuple[int, int]]:
    """The union of the intervals [d, d + tile), d in ``shifts``, as
    sorted disjoint (lo, width) pairs."""
    out: List[Tuple[int, int]] = []
    for d in sorted(set(shifts)):
        if out and d < out[-1][0] + out[-1][1]:
            lo = out[-1][0]
            out[-1] = (lo, d + tile - lo)
        else:
            out.append((d, tile))
    return out


def _holding(clusters, lo: int, hi: int) -> int:
    """Index of the cluster that holds the rows [lo, hi)."""
    for c, (clo, w) in enumerate(clusters):
        if clo <= lo and hi <= clo + w:
            return c
    raise AssertionError(f"no cluster holds [{lo}, {hi})")


def window_table(offsets: Sequence[int], tile: int) -> List[int]:
    """The row-window table of a sweep CTA of ``tile`` rows (the layout of
    ``Window`` in csrc/common.cuh).

    The inner window (u', w') holds the tile's rows shifted by D1 = the
    offsets and 0, the outer window (p', z) those shifted by D1 and every
    d + off (d in D1, off in the offsets); each is merged into clusters
    of consecutive shared-memory slots.
    """
    offs = [int(o) for o in offsets]
    d1 = set(offs) | {0}
    d2 = d1 | {d + o for d in d1 for o in offs}
    cl2, cl1 = _clusters(d2, tile), _clusters(d1, tile)
    base2 = [sum(w for _, w in cl2[:c]) for c in range(len(cl2))]
    base1 = [sum(w for _, w in cl1[:c]) for c in range(len(cl1))]

    def outer(lo, w, shift):  # outer slot of row e + shift is e + this
        k = _holding(cl2, lo + shift, lo + w + shift)
        return base2[k] - cl2[k][0] + shift

    c_own = _holding(cl1, 0, tile)
    k_own = _holding(cl2, 0, tile)
    tab = [len(cl2), len(cl1), sum(w for _, w in cl2),
           sum(w for _, w in cl1), c_own, base1[c_own] - cl1[c_own][0],
           base2[k_own] - cl2[k_own][0], 0]
    for cl, base in ((cl2, base2), (cl1, base1)):
        for (lo, w), b in zip(cl, base):
            tab += [lo, w, b]
    for lo, w in cl1:
        tab += [outer(lo, w, o) for o in offs] + [outer(lo, w, 0)]
    for o in offs:
        c = _holding(cl1, o, o + tile)
        tab.append(base1[c] - cl1[c][0] + o)
    return tab


def window_smem(table: Sequence[int], tile: int, own: int,
                acc_bytes: int) -> int:
    """Dynamic shared memory of a sweep CTA: the table (16-byte aligned),
    both windows and ``own`` tile-sized arrays at the accumulator dtype."""
    return (-(-4 * len(table) // 16) * 16
            + (table[2] + table[3] + own * tile) * acc_bytes)


def window_plan(offsets: Sequence[int], acc_bytes: int, own: int,
                max_tile: int = None, target: int = None
                ) -> Tuple[int, List[int], int]:
    """(tile rows, window table, shared-memory bytes) of a sweep CTA.

    A CTA's threads take ``SWEEP_STEP`` slots of a window at a time (four
    a thread), and each such batch costs about one trip to memory.  Among
    the tiles up to ``max_tile`` (default ``SWEEP_TILE``) whose shared
    memory (:func:`window_smem`) stays within ``target`` (default
    ``SWEEP_SMEM_TARGET``), so several CTAs share an SM, take the one with
    the fewest batches per row: those of the outer window, the inner
    window and the own rows, plus ``SWEEP_FIXED`` for the CTA's set-up and
    sums.  So ex23's PIPECG tile is 1020 rows, its windows 1024 and 1022
    slots, one batch each.  Where even 32 rows pass the target (bands far
    apart in every direction), the largest tile within
    ``SWEEP_SMEM_LIMIT``, down to one row.  ``own`` is the sweep's
    own-row arrays: 1 for PIPECG (r'), 3 for p-BiCGStab (r', a', c').
    """
    cap = SWEEP_TILE if max_tile is None else max_tile
    target = SWEEP_SMEM_TARGET if target is None else target
    tiles = list(range(cap - cap % 4, 3, -4)) + [2, 1]
    best, best_cost = None, None
    for tile in tiles:
        if tile < 32:
            break
        table = window_table(offsets, tile)
        smem = window_smem(table, tile, own, acc_bytes)
        if smem > target:
            continue
        batches = sum(-(-w // SWEEP_STEP) for w in (table[2], table[3], tile))
        cost = (batches + SWEEP_FIXED) / tile
        if best is None or cost < best_cost:
            best, best_cost = (tile, table, smem), cost
    if best is not None:
        return best
    for tile in tiles:
        table = window_table(offsets, tile)
        smem = window_smem(table, tile, own, acc_bytes)
        if smem <= SWEEP_SMEM_LIMIT:
            return tile, table, smem
    raise AssertionError("no window fits shared memory")


def sweep_plan(offsets: Sequence[int], acc_bytes: int
               ) -> Tuple[int, List[int], int]:
    """The PIPECG sweep's :func:`window_plan` (one own-row array, r')."""
    return window_plan(offsets, acc_bytes, 1)


_PLANS: Dict[tuple, Tuple[int, torch.Tensor, int]] = {}
_TICKETS: Dict[tuple, torch.Tensor] = {}


def device_plan(plan: Callable, offsets: Sequence[int], acc_bytes: int,
                device: torch.device) -> Tuple[int, torch.Tensor, int]:
    """A sweep's ``plan(offsets, acc_bytes)`` (its :func:`sweep_plan`)
    with the table on ``device``, built once per operator, dtype and
    device (the sweeps reuse it every iteration)."""
    key = (plan, tuple(int(o) for o in offsets), acc_bytes, str(device))
    if key not in _PLANS:
        tile, table, smem = plan(offsets, acc_bytes)
        _PLANS[key] = (tile, torch.tensor(table, dtype=torch.int32,
                                          device=device), smem)
    return _PLANS[key]


def finish_groups(nblk: int) -> int:
    """Groups of the two-level finish of ``nblk`` CTAs."""
    return -(-nblk // FINISH_GROUP)


def tickets(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` int32 tickets of the sweeps' finish, one set per
    device and stream, zero between launches (the CTAs that finish set
    theirs back), so launches on one stream share them."""
    key = (str(device), _b.stream_of(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


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
            beta, oext: int, strips=None, n_valid: Optional[int] = None
            ) -> Tuple[torch.Tensor, ...]:
    """Check the operands and launch the sweep kernel on x's device.

    ``bands`` (n_bands, n + 2 oext) and ``inv_diag`` (n + 2 oext,) hold the
    operator rows [-oext, n + oext); ``strips`` is None (zero outside
    [0, n)) or (u_lo, u_hi, p_lo, p_hi), each (k, 2h).  Rows >= ``n_valid``
    (default n) stay out of the reduction row.
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
    tile, plan, smem = device_plan(sweep_plan, offsets, x.element_size(),
                                   x.device)
    nblk = -(-n // tile)
    ngroups = finish_groups(nblk)
    xo, ro, uo, po = (torch.empty_like(v) for v in (x, r, u, p))
    partials = torch.empty((k, nblk + ngroups, NRED), dtype=x.dtype,
                           device=x.device)
    red = torch.empty((k, NRED), dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    P = _b.ptr
    lo_hi = [P(t) for t in strips] if strips is not None else [None] * 4
    with torch.cuda.device(x.device):
        rc = _b.lib().rt_pipecg_spmv_fused(
            _b.dtype_code(name, x), _b.dtype_code(name, r), offs, nb, n, k,
            P(bands), P(inv_diag), oext, P(csum),
            P(x), P(r), P(u), P(p),
            *lo_hi, 2 * h, n if n_valid is None else n_valid,
            P(alpha), P(beta), P(xo), P(ro), P(uo), P(po),
            P(plan), plan.numel(), tile, smem, P(partials), nblk,
            P(tickets(x.device, k * (ngroups + 1))), P(red),
            _b.stream_of(x.device))
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


# ---------------------------------------------------------------------------
# Depth-l ghost-chain sweep
# ---------------------------------------------------------------------------

def _chain_accum(p: torch.Tensor, accum_dtype) -> torch.dtype:
    """Links' and Gram's dtype: ``accum_dtype``, else p's widened to f32."""
    if accum_dtype is not None:
        return accum_dtype
    return p.dtype if p.dtype in _b.ACCUM_DTYPES else torch.float32


def _theta_inv(theta, acc, device) -> torch.Tensor:
    """``1 / theta`` at ``acc`` (theta cast first, as the reference does)."""
    th = (theta.to(device=device, dtype=acc) if torch.is_tensor(theta)
          else torch.tensor(float(theta), dtype=acc, device=device))
    return (1.0 / th).reshape(())


def _chain_plain(offsets, bands_ext, p_e, r_e, theta, l: int, acc
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's arithmetic over rows [-l*h, n + l*h) in plain torch.

    ``bands_ext``, ``p_e`` and ``r_e`` hold those rows; link j is kept on
    rows [-(l - j) h, n + (l - j) h), each row zero, + band_k * (link
    j-1 at row + off_k) in band order, * (1/theta), as the kernel does.
    Returns (C (2l+1, n) in p's dtype, Gram at ``acc``).
    """
    h = _halo(offsets)
    H = l * h
    n = p_e.shape[-1] - 2 * H
    th_inv = _theta_inv(theta, acc, p_e.device)
    bands_a = bands_ext.to(acc)

    def links(v, depth):
        a = v.to(acc)
        out = [a[H:H + n]]
        for j in range(1, depth + 1):
            width = n + 2 * (H - j * h)
            nxt = torch.zeros(width, dtype=acc, device=a.device)
            for k, off in enumerate(offsets):
                nxt = nxt + bands_a[k, j * h:j * h + width] \
                    * a[h + off:h + off + width]
            a = nxt * th_inv
            out.append(a[H - j * h:H - j * h + n])
        return out

    C = torch.stack(links(p_e, l) + links(r_e, l - 1))
    return C.to(p_e.dtype), C @ C.T


def ghost_chain_fused_plain(offsets: Sequence[int], bands, p, r, theta,
                            l: int, accum_dtype=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-device chain sweep in plain torch (zero beyond the matrix).

    p, r (n,), bands (n_bands, n), theta a scalar.  Returns (C (2l+1, n),
    Gram (2l+1, 2l+1)).
    """
    H = l * _halo(offsets)
    pad = torch.nn.functional.pad
    return _chain_plain(offsets, pad(bands, (H, H)), pad(p, (H, H)),
                        pad(r, (H, H)), theta, l,
                        _chain_accum(p, accum_dtype))


def ghost_chain_halo_plain(offsets: Sequence[int], bands_ext, p, r, p_lo,
                           p_hi, r_lo, r_hi, theta, l: int, accum_dtype=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's chain sweep in plain torch.

    p, r (n,) local rows; p_lo/p_hi/r_lo/r_hi (l*h,) the rows [-l*h, 0)
    and [n, n + l*h); bands_ext (n_bands, n + 2 l*h) the operator rows
    [-l*h, n + l*h).  Returns (C, this rank's PARTIAL Gram).
    """
    return _chain_plain(offsets, bands_ext, torch.cat([p_lo, p, p_hi]),
                        torch.cat([r_lo, r, r_hi]), theta, l,
                        _chain_accum(p, accum_dtype))


def chain_plan(reach: int, m: int, acc_bytes: int) -> Tuple[int, int, bool]:
    """(tile rows, workspace words per CTA, in shared memory?) of a sweep.

    The workspace holds two windows of tile + 2 reach rows and the
    (m, tile) link block: in shared memory when it fits ``SMEM_DYNAMIC``,
    else in a global scratch.
    """
    tile = CHAIN_TILE if 2 * reach <= CHAIN_TILE else 2 * CHAIN_TILE
    ws = 2 * (tile + 2 * reach) + m * tile
    return tile, ws, ws * acc_bytes <= _b.SMEM_DYNAMIC


def _chain_launch(name: str, offsets, bands, p, r, theta, l: int,
                  accum_dtype, oext: int, strips=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the operands and launch the chain kernel on p's device.

    ``bands`` (n_bands, n + 2 oext) holds the operator rows
    [-oext, n + oext); ``strips`` is None (zero outside [0, n)) or
    (p_lo, p_hi, r_lo, r_hi), each (l*h,).
    """
    (n,) = p.shape
    nb = len(offsets)
    if not 1 <= nb <= _b.MAX_BANDS:
        raise ValueError(f"{name}: {nb} bands, the kernel takes 1.."
                         f"{_b.MAX_BANDS}")
    if l < 1:
        raise ValueError(f"{name}: depth l={l} < 1")
    acc = _chain_accum(p, accum_dtype)
    if acc not in _b.ACCUM_DTYPES:
        raise ValueError(f"{name}: accumulator must be float32 or float64")
    sto = p.dtype
    H = l * _halo(offsets)
    shapes = [("r", r, (n,)), ("bands", bands, (nb, n + 2 * oext))]
    if strips is not None:
        shapes += [(key, t, (H,)) for key, t in
                   zip(("p_lo", "p_hi", "r_lo", "r_hi"), strips)]
    for key, t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != sto:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {sto}")
    th_inv = _theta_inv(theta, acc, p.device).contiguous()
    _b.check_cuda(name, p.device, p=p, th_inv=th_inv,
                  **{key: t for key, t, _ in shapes})
    m = 2 * l + 1
    tile, ws, shared = chain_plan(H, m, torch.finfo(acc).bits // 8)
    nblk = -(-n // tile)
    chain = torch.empty((m, n), dtype=sto, device=p.device)
    partials = torch.empty((m * (m + 1) // 2, nblk), dtype=acc,
                           device=p.device)
    gram = torch.empty((m, m), dtype=acc, device=p.device)
    scratch = None if shared else torch.empty(nblk * ws, dtype=acc,
                                              device=p.device)
    offs = (ctypes.c_int * nb)(*[int(o) for o in offsets])
    P = _b.ptr
    lo_hi = [P(t) for t in strips] if strips is not None else [None] * 4
    with torch.cuda.device(p.device):
        rc = _b.lib().rt_ghost_chain(
            _b.DTYPE_CODES[acc], _b.dtype_code(name, p), offs, nb, n, l,
            P(bands), oext, P(p), P(r), *lo_hi, H, n, P(th_inv),
            P(chain), tile, P(scratch), ws, P(partials), nblk, P(gram),
            _b.stream_of(p.device))
    _b.raise_on_error(name, rc)
    return chain, gram


def ghost_chain_fused(offsets: Sequence[int], bands, p, r, theta, l: int,
                      accum_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-l ghost basis and its Gram matrix on one device.

    p, r (n,), bands (n_bands, n), theta a scalar or 0-d tensor.  Returns
    (C (2l+1, n) in p's dtype, Gram (2l+1, 2l+1) at ``accum_dtype``,
    default p's dtype widened to at least float32).  CUDA tensors launch
    the CUDA kernel (or raise); CPU tensors take
    :func:`ghost_chain_fused_plain`.  ``ghost_chain_fused.launches``
    counts kernel launches.
    """
    if _on_cpu("ghost_chain_fused", p, bands, r):
        return ghost_chain_fused_plain(offsets, bands, p, r, theta, l,
                                       accum_dtype)
    outs = _chain_launch("ghost_chain_fused", offsets, bands, p, r, theta, l,
                         accum_dtype, oext=0)
    ghost_chain_fused.launches += 1
    return outs


def ghost_chain_halo(offsets: Sequence[int], bands_ext, p, r, p_lo, p_hi,
                     r_lo, r_hi, theta, l: int, accum_dtype=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's depth-l ghost basis and PARTIAL Gram matrix.

    p, r (n,) local rows; p_lo/p_hi/r_lo/r_hi (l*h,) the rows [-l*h, 0)
    and [n, n + l*h) (zeros at the ends of the chain); bands_ext
    (n_bands, n + 2 l*h) the operator rows [-l*h, n + l*h).  The caller
    finishes the Gram with an all-reduce.  CUDA tensors launch the chain
    kernel (or raise); CPU tensors take :func:`ghost_chain_halo_plain`.
    ``ghost_chain_halo.launches`` counts kernel launches.
    """
    strips = (p_lo, p_hi, r_lo, r_hi)
    if _on_cpu("ghost_chain_halo", p, bands_ext, r, *strips):
        return ghost_chain_halo_plain(offsets, bands_ext, p, r, *strips,
                                      theta, l, accum_dtype)
    outs = _chain_launch("ghost_chain_halo", offsets, bands_ext, p, r, theta,
                         l, accum_dtype, oext=l * _halo(offsets),
                         strips=strips)
    ghost_chain_halo.launches += 1
    return outs


ghost_chain_fused.launches = 0
ghost_chain_halo.launches = 0
