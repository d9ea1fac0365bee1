"""Many-rank Krylov solves over a ``torch.distributed`` process group.

The paper's computational model, on P ranks of one group (a 1-D chain):

  local computation   = per-rank DIA SpMV + AXPYs
  halo exchange       = send/recv of edge strips with the chain neighbours
  global sync         = all-reduce for every inner product

``distributed_solve(..., engine=None)`` runs any solver that takes a
``dot=`` (cg / cr / pipecg / pipecr / gmres / pgmres) on this rank's rows
with a halo matvec (plain torch, or the extended-x SpMV kernel with
``use_kernel=True``) and an all-reduce dot: every reduction is waited for
where it is issued.  ``engine="sharded_fused"`` runs PIPECG/PIPECR as one
halo sweep kernel per rank per iteration (kernels/pipecg_spmv_fused.py::
pipecg_spmv_halo) that emits a PARTIAL (k, 6) row, and the all-reduce that
finishes it is split-phase (distributed/overlap.py): issued at the end of
iteration i and waited for in iteration i+1 after that iteration's halo
exchange, before the kernel that needs alpha and beta.  That window is the
MPI_Iallreduce/MPI_Wait overlap the paper is about.  ``pipebicgstab`` runs
the same way on its own sweep (kernels/pipebicgstab_fused.py::
pipebicgstab_halo), whose one (7, 6) payload hides BiCGStab's four
synchronizations; on the inline path it finishes its Gram with one
all-reduce per iteration.  ``pipecg_l`` with ``l > 1`` runs depth-l
ghost-basis blocks (:func:`sharded_pipecg_depth_solve`): one l*h strip
exchange, one chain sweep (kernels/pipecg_spmv_fused.py::ghost_chain_halo)
and one all-reduce per l iterations; the inline path rejects it.

A ``BsrMatrix`` runs PIPECG on block rows over the chain
(:func:`sharded_pipecg_bsr_solve`), and a DIA lattice operator on a
``(py, px)`` grid of ranks (``group=(process_group, (py, px))``) runs it
tile by tile with N/S/W/E strips (:func:`sharded_pipecg_solve_2d`); both
are plain torch with the split-phase all-reduce, as the JAX package's
bodies are plain jnp.

Where the JAX package takes a mesh, this one takes a process ``group``
(None: the default group).  Each rank slices its rows of the global ``A``
and ``b``; the result's ``x`` is the global vector (one all-gather per
solve); ``iters``, ``res_norm`` and the histories are the same on every
rank.  ``noise=`` (a NoiseHook, core/noise/injection.py) sleeps a sampled
wait once per iteration on every rank: after each SpMV on the inline path,
between the kernel launch and the issue of the reduction on the sharded
path, so the stall sits on the critical path.  A fault injector
(core/noise/faults.py) also returns a tick that is added to the SpMV
output or to the partial row before its reduction: NaN from a killed rank
poisons every rank's result within one iteration.

The sharded PIPECG and p-BiCGStab bodies take the int8 wire of a
``PrecisionPolicy`` (distributed/compression.py), and the PIPECG body the
elastic warm start ``x0=`` / ``carried=`` / ``with_state=`` that
distributed/fault.py::resilient_distributed_solve segments a solve with.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.core.krylov.base import SolveResult, make_allreduce_dot
from repro_torch.core.krylov.operator import BsrMatrix
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.core.krylov.options import SolverOptions, as_policy
from repro_torch.distributed import comm
from repro_torch.distributed.overlap import SplitPhaseReduce

# solver name -> inner product of its sharded body (CR is CG in the A-norm)
_SHARDED_IP = {"pipecg": "id", "pipecg_multi": "id", "pipecr": "A"}
# solvers with a sharded body family of their own (ShardedFusedEngine._BODIES)
_SHARDED_FAMILY = {"pipecg_l": "pipecg_l", "pipebicgstab": "pipebicgstab"}


def halo_exchange_cols(x, halo: int, group=None):
    """(left, right) strips of width ``halo`` along the LAST axis.

    Works for any leading shape: vectors (n,), right-hand-side batches
    (k, n) and band stacks (n_bands, n) exchange their edge columns with
    the chain neighbours; the chain's end ranks receive zeros (the zero
    extension of the DIA bands at the matrix boundary).  A list of
    tensors of one shape exchanges in one message a neighbour and gives a
    list of pairs (:func:`comm.exchange_along`).
    """
    return _chain_exchange(x, halo, -1, group)


def _chain_exchange(v, w: int, axis: int, group=None):
    """:func:`comm.exchange_along` with the chain neighbours rank -+ 1."""
    rank, world = comm.rank_and_size(group)
    return comm.exchange_along(v, w, axis, rank - 1 if rank > 0 else None,
                               rank + 1 if rank < world - 1 else None,
                               group)


def halo_exchange(x_local: torch.Tensor, halo: int, group=None):
    """1-D vector variant of :func:`halo_exchange_cols` (same semantics)."""
    return halo_exchange_cols(x_local, halo, group)


def halo_exchange_compressed(xs, halo: int, group, ef_lo, ef_hi,
                             use_ef: bool):
    """int8-wire variant of :func:`halo_exchange_cols` for a list of
    vectors of one shape (every vector's strips travel in one message a
    neighbour).

    Each edge strip is quantized at the sender
    (distributed/compression.py::compress_halo) and travels as int8: the
    float32 scale's four bytes, then the int8 payload; a quarter of an
    fp32 strip's bytes (an eighth of fp64's).  The strips derive only
    from the carried vectors, never from the pending reduction, so the
    split-phase order is unchanged.

    ``ef_lo`` / ``ef_hi`` list the sender-side error-feedback strips of
    the low and high edge of each vector (``x.shape[:-1] + (halo,)``,
    x's dtype); with ``use_ef`` the quantization residual of the same
    rows re-enters next iteration, else the returned feedback is zero.
    Returns one ``(lo, hi, new_ef_lo, new_ef_hi)`` a vector: the
    received strips in x's dtype, zeros at the ends of the chain; one
    rank or ``halo == 0`` gives zero strips and zero feedback.
    """
    from repro_torch.distributed import compression as comp

    rank, world = comm.rank_and_size(group)
    shape = xs[0].shape[:-1] + (halo,)
    if world == 1 or halo == 0:
        out = []
        for v, lo, hi in zip(xs, ef_lo, ef_hi):
            z = torch.zeros(shape, dtype=v.dtype, device=v.device)
            out.append((z, z, torch.zeros_like(lo), torch.zeros_like(hi)))
        return out
    packs, feedback = [], []
    for v, lo, hi in zip(xs, ef_lo, ef_hi):
        # the high edge travels up the chain (the neighbour's low strip),
        # the low edge down, as on the full-width wire
        q_hi, s_hi, ef_hi_new = comp.compress_halo(
            v[..., -halo:], hi if use_ef else None)
        q_lo, s_lo, ef_lo_new = comp.compress_halo(
            v[..., :halo], lo if use_ef else None)
        # one cat: row 0 (the low strip) goes to the low neighbour, row 1
        # to the high one
        packs.append(torch.cat([s_lo.reshape(1).view(torch.int8),
                                q_lo.reshape(-1),
                                s_hi.reshape(1).view(torch.int8),
                                q_hi.reshape(-1)]).view(2, -1))
        feedback.append((ef_lo_new, ef_hi_new) if use_ef else
                        (torch.zeros_like(lo), torch.zeros_like(hi)))
    arrived = _chain_exchange(packs, 1, 0, group)

    def unpack(buf, present, dtype, device):
        if not present:     # the end of the chain: the zero extension
            return torch.zeros(shape, dtype=dtype, device=device)
        buf = buf.reshape(-1)   # (a view at any offset: copy the scale)
        return comp.decompress_halo(buf[4:].reshape(shape),
                                    buf[:4].clone().view(torch.float32),
                                    dtype)

    return [(unpack(from_low, rank > 0, v.dtype, v.device),
             unpack(from_high, rank < world - 1, v.dtype, v.device),
             ef_l, ef_h)
            for v, (from_low, from_high), (ef_l, ef_h)
            in zip(xs, arrived, feedback)]


def _tick(noise, rank: int, like: torch.Tensor) -> torch.Tensor:
    """Call ``noise`` for this rank and add its tick to ``like``.

    A plain NoiseHook only sleeps and returns None (``like`` is returned
    as it is); a fault injector (core/noise/faults.py) returns a scalar
    tick, NaN once its shard is killed or a corrupt fault's magnitude,
    which rides the row into the next reduction.
    """
    tick = noise(rank)
    if tick is None:
        return like
    return like + torch.as_tensor(tick, dtype=like.dtype, device=like.device)


def dia_matvec_local(offsets: Sequence[int], bands_local, x_local,
                     group=None, use_kernel: bool = False) -> torch.Tensor:
    """This rank's rows of ``A x`` with a halo exchange.

    bands_local (n_bands, n_local); x_local (n_local,) or (k, n_local).
    ``use_kernel`` applies the bands to the exchanged x_ext with the
    extended-x SpMV kernel (kernels/spmv_dia.py::spmv_dia_ext), else in
    plain torch.
    """
    halo = max(abs(int(o)) for o in offsets)
    left, right = halo_exchange(x_local, halo, group)
    x_ext = torch.cat([left, x_local, right], dim=-1)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.spmv_dia_ext_step(offsets, bands_local, x_ext, halo)
    n_local = x_local.shape[-1]
    y = torch.zeros_like(x_local)
    for k, off in enumerate(offsets):
        y = y + bands_local[k] * x_ext[..., halo + off:halo + off + n_local]
    return y


# ---------------------------------------------------------------------------
# Sharded fused engine: halo sweep kernel + split-phase all-reduce
# ---------------------------------------------------------------------------

def _local_partials(r, u, w, csum):
    """This rank's (k, 6) row [<r,u>, <w,u>, <r,r>, <r,w>, <w,w>,
    1^T w - c^T u] through the multi-dot kernel (kernels/fused_dots.py).

    ``csum`` is this rank's slice of the GLOBAL column checksum c = A^T 1,
    so the all-reduced last entry is 1^T (A u) - c^T u.
    """
    from repro_torch.kernels import ops as kops

    rows = []
    for rj, uj, wj in zip(r, u, w):
        rw = torch.stack([rj, wj])
        d_u = kops.fused_dots(rw, uj)          # <r,u>, <w,u>
        d_r = kops.fused_dots(rw, rj)          # <r,r>, <w,r> = <r,w>
        d_w = kops.fused_dots(wj[None], wj)    # <w,w>
        chk = (torch.sum(wj) - torch.sum(csum * uj))[None]
        rows.append(torch.cat([d_u, d_r, d_w, chk]))
    return torch.stack(rows)


def _frz(mask, nv, ov):
    """``ov`` where the per-system flag ``mask`` (k,) is set, else ``nv``."""
    m = mask.reshape(mask.shape + (1,) * (nv.dim() - mask.dim()))
    return torch.where(m, ov, nv)


def sharded_pipecg_solve(offsets: Tuple[int, ...], bands_local, b_local, *,
                         group=None, ip: str = "id", M=None,
                         maxiter: int = 100, tol: float = 0.0, noise=None,
                         x0=None, carried=None, with_state: bool = False,
                         precision=None, recorder=None):
    """Per-rank PIPECG/PIPECR body of the ShardedFusedEngine.

    Each iteration is one halo sweep (``kops.pipecg_spmv_halo_step``) plus
    one all-reduce of its (k, 6) partial row (the five Krylov partials and
    the ABFT checksum partial ``1^T w' - c^T u'``), in this order:

    1. the halo exchange of u and p (needs only the carried vectors);
    2. the wait for the reduction issued at the end of the last iteration;
    3. the alpha/beta recurrence on its result;
    4. the kernel;
    5. ``noise`` (if any; its tick is added to the row), then the issue
       of this iteration's reduction.

    ``recorder`` (an overlap.OrderRecorder) logs that order.  The history
    comes out shifted by one, since the reduction consumed at iteration i
    was issued at i-1; a final wait supplies ``||r_maxiter||`` and the
    history is rolled into the local solvers' alignment
    (hist[i] = ||r_{i+1}||), the checksum column with it as
    ``detect_history``.

    ``M`` is None or "jacobi" (preconditioned in the kernel).  A bf16/fp8
    ``precision`` stores r, u, p and the operator narrow; x, the rows and
    the recurrences stay at b's dtype.  The sweep's column sums are those
    of the operator it streams, summed at the storage dtype as the JAX
    package's halo wrapper sums them; the set-up row takes them from the
    full-precision operator.  ``wire='int8'`` exchanges u and p through
    :func:`halo_exchange_compressed` (sender-side error feedback unless
    ``error_feedback=False``); ``wire_gram='int8'`` squeezes every partial
    row through ``compression.compress_gram`` before its issue, the ABFT
    checksum column preserved, a noise tick added after it.

    Elastic warm start (distributed/fault.py): ``with_state=True`` also
    returns this rank's carried state ``{x, r, u, p, gamma_prev,
    alpha_prev, done}`` in the batched (k, .) form; ``carried=`` (the same
    dict, sliced to this rank's rows) continues exactly from it, the
    partial row recomputed from (r, u, A u); ``x0=`` restarts the
    recurrence from an iterate with one synchronous ``r = b - A x0``.
    The wire's feedback strips are not carried: they restart at zero.
    """
    from repro_torch.distributed import compression as comp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.checksum import dia_column_checksum

    if carried is not None and x0 is not None:
        raise ValueError("pass either x0 (residual-replacement restart) or "
                         "carried (exact continuation), not both")
    policy = as_policy(precision)
    rank, _ = comm.rank_and_size(group)
    halo = max(abs(int(o)) for o in offsets)
    batched = b_local.dim() == 2
    B = b_local if batched else b_local[None]
    k_rhs, n_local = B.shape
    dt, dev = B.dtype, B.device
    if n_local < 2 * halo:
        raise ValueError(
            f"sharded_fused engine: local shard of {n_local} rows is "
            f"narrower than the 2*halo={2 * halo} stencil reach")
    if M is None:
        invd = torch.ones((n_local,), dtype=dt, device=dev)
    elif isinstance(M, str) and M == "jacobi":
        invd = (1.0 / bands_local[list(offsets).index(0)]).to(dt)
    else:
        raise ValueError(
            "sharded_fused engine preconditions in-kernel: M must be None "
            f"or 'jacobi', got {M!r}")

    # loop-invariant operator extension: one exchange per solve
    bl, br = halo_exchange_cols(bands_local, halo, group)
    bands_ext = torch.cat([bl, bands_local, br], dim=-1)
    il, ir = halo_exchange_cols(invd, halo, group)
    invd_ext = torch.cat([il, invd, ir], dim=-1)
    # this rank's slice of the GLOBAL c = A^T 1 (every contributing band
    # value is in the extended bands): the set-up row's from the
    # full-precision operator, the sweep's from the operator it streams
    csum = dia_column_checksum(offsets, bands_ext, halo=halo).to(dt)
    sdt = policy.storage_dtype
    sto = dt if sdt is None else sdt
    bands_s, invd_s = (t.to(sto).contiguous() for t in (bands_ext, invd_ext))
    csum_s = dia_column_checksum(offsets, bands_s, halo=halo).contiguous()
    wire_halo = policy.wire == "int8"
    wire_gram = policy.wire_gram == "int8"
    use_ef = policy.error_feedback

    one = torch.ones((k_rhs,), dtype=dt, device=dev)
    if carried is not None:
        x, r, u, p = (carried[k].to(dt) for k in ("x", "r", "u", "p"))
        gamma_prev = carried["gamma_prev"].to(dt)
        alpha_prev = carried["alpha_prev"].to(dt)
        done = carried["done"].to(torch.bool)
        first = False
    else:
        if x0 is None:
            x, r = torch.zeros_like(B), B
        else:
            x = (x0 if batched else x0[None]).to(dt)
            # the synchronous true residual: the residual-replacement
            # re-glue after a disruptive recovery
            r = B - dia_matvec_local(offsets, bands_local, x, group)
        u = invd * r
        p = torch.zeros_like(B)
        gamma_prev, alpha_prev = one, one
        done = torch.zeros((k_rhs,), dtype=torch.bool, device=dev)
        first = True
    w = dia_matvec_local(offsets, bands_local, u, group)
    red = _local_partials(r, u, w, csum)
    r, u, p = r.to(sto), u.to(sto), p.to(sto)
    # the checksum column rides the reduction exact (compression.py)
    chk_mask = torch.zeros((k_rhs, 6), dtype=torch.bool, device=dev)
    chk_mask[:, 5] = True
    if wire_gram:   # the feedback ``gef`` is read only with use_ef
        red, gef = comp.compress_gram(red, None, preserve=chk_mask)
    if wire_halo:
        # sender-side feedback strips, one per edge per exchanged vector
        efu_l = efu_r = efp_l = efp_r = torch.zeros(
            (k_rhs, 2 * halo), dtype=sto, device=dev)
    tol2 = torch.as_tensor(tol, dtype=dt, device=dev) ** 2 \
        * comm.all_reduce(torch.sum(B * B, dim=-1), group)

    reducer = SplitPhaseReduce(group, recorder)
    pending = reducer.issue(red, iteration=-1)
    iters = torch.zeros((k_rhs,), dtype=torch.int32, device=dev)
    hist, chk_hist = [], []
    for i in range(maxiter):
        # 1. halo strips for THIS iteration's sweep: carried vectors only
        # (both vectors' strips in one message a neighbour)
        if wire_halo:
            (ul, ur, efu_l, efu_r), (pl, pr, efp_l, efp_r) = \
                halo_exchange_compressed([u, p], 2 * halo, group,
                                         [efu_l, efp_l], [efu_r, efp_r],
                                         use_ef)
        else:
            (ul, ur), (pl, pr) = halo_exchange_cols([u, p], 2 * halo, group)
        if recorder is not None:
            recorder("halo", i)
        # 2. finish the reduction issued LAST iteration; its only
        # consumers are the scalar recurrences below
        red_sum = pending.wait()
        gamma, delta = ((red_sum[:, 0], red_sum[:, 1]) if ip == "id"
                        else (red_sum[:, 3], red_sum[:, 4]))
        rr = red_sum[:, 2]
        chk = red_sum[:, 5]
        if first:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_prev
            alpha = gamma / (delta - beta * gamma / alpha_prev)
        x2, r2, u2, p2, red_new = kops.pipecg_spmv_halo_step(
            offsets, bands_s, invd_s, csum_s, x, r, u, p, ul, ur, pl, pr,
            alpha, beta)
        if recorder is not None:
            recorder("launch", i)
        if wire_gram:
            red_new, gef = comp.compress_gram(
                red_new, gef if use_ef else None, preserve=chk_mask)
        if noise is not None:
            # the stall delays this rank's contribution; a fault's tick
            # rides the row into the reduction
            red_new = _tick(noise, rank, red_new)

        mask = done
        if not policy.is_default:
            # low-precision breakdown guard: freeze AT the last good
            # iterate instead of propagating NaN
            bad = ~(torch.isfinite(gamma) & torch.isfinite(alpha)
                    & torch.isfinite(rr))
            mask = mask | bad
        done = mask | (rr <= tol2)
        x, r, u, p = (_frz(mask, nv, ov) for nv, ov in
                      ((x2, x), (r2, r), (u2, u), (p2, p)))
        red = _frz(mask, red_new, red)
        gamma_prev = _frz(mask, gamma, gamma_prev)
        alpha_prev = _frz(mask, alpha, alpha_prev)
        first = False
        iters = iters + (~done).to(torch.int32)
        pending = reducer.issue(red, iteration=i)
        hist.append(torch.sqrt(torch.clamp(rr, min=0.0)))
        chk_hist.append(chk)

    red_fin = pending.wait()
    res = torch.sqrt(torch.clamp(red_fin[:, 2], min=0.0))
    if maxiter:
        # roll the shifted history into hist[i] = ||r_{i+1}||
        hist = torch.stack(hist[1:] + [res])          # (maxiter, k)
        chk_hist = torch.stack(chk_hist[1:] + [red_fin[:, 5]])
    else:
        hist = chk_hist = torch.zeros((0, k_rhs), dtype=dt, device=dev)
    if batched:
        result = SolveResult(x=x, iters=iters, res_norm=res,
                             res_history=hist.T, detect_history=chk_hist.T)
    else:
        result = SolveResult(x=x[0], iters=iters[0], res_norm=res[0],
                             res_history=hist[:, 0],
                             detect_history=chk_hist[:, 0])
    if not with_state:
        return result
    # the batched (k, .) form always, so that a later segment under any
    # group can take it back as ``carried=``
    return result, dict(x=x, r=r, u=u, p=p, gamma_prev=gamma_prev,
                        alpha_prev=alpha_prev, done=done)


# ---------------------------------------------------------------------------
# Sharded pipelined BiCGStab: ONE strip exchange + ONE (7, 6) all-reduce
# ---------------------------------------------------------------------------

def sharded_pipebicgstab_solve(offsets: Tuple[int, ...], bands_local,
                               b_local, *, group=None, M=None,
                               maxiter: int = 100, tol: float = 0.0,
                               noise=None, precision=None, recorder=None
                               ) -> SolveResult:
    """Per-rank pipelined BiCGStab body of the ShardedFusedEngine.

    Each iteration is one halo sweep (``kops.pipebicgstab_halo_step``) plus
    one all-reduce of its PARTIAL (7, 6) payload: the Gram matrix of
    ``[r, w, t, a, c, r_hat]`` and the ABFT checksum partial
    ``1^T t' - c^T w'`` in row 6.  The reduction is split-phase, in the
    order of :func:`sharded_pipecg_solve`:

    1. the strip exchange of w, t and c (the carried vectors only, one
       message a neighbour);
    2. the wait for the payload issued at the end of the last iteration;
    3. the alpha/beta/omega recurrence on it
       (core/krylov/bicgstab.py::pbicgstab_scalars), which hides all four
       classical synchronizations;
    4. the kernel;
    5. ``noise`` (if any), then the issue of this iteration's payload.

    Single right-hand side (``b_local`` (n_local,)).  ``M`` is None or
    "jacobi": right preconditioning folded into the local bands as column
    scaling, with one exchange of diag^-1 per solve; residuals are TRUE
    residuals of ``A x = b`` and x is unscaled locally at the end.  The
    history is rolled into the local solver's alignment.  A bf16/fp8
    ``precision`` stores r, w, t, pa, a, c, r_hat and the operator
    extension narrow; x, the payload and the recurrence stay at b's
    dtype.  The sweep's column sums are those of the operator it streams
    (summed at the storage dtype, as the JAX package's halo wrapper sums
    them), the set-up row's those of the full-precision operator.
    ``wire='int8'`` exchanges the w, t and c strips through
    :func:`halo_exchange_compressed`; ``wire_gram='int8'`` squeezes each
    partial payload through ``compression.compress_gram`` before its
    issue, entry [6, 0] (the checksum) preserved.
    """
    from repro_torch.core.krylov.bicgstab import _eps, pbicgstab_scalars
    from repro_torch.distributed import compression as comp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.checksum import dia_column_checksum

    policy = as_policy(precision)
    if b_local.dim() != 1:
        raise ValueError(
            "the sharded pipebicgstab path is single-RHS; batch over "
            "solves instead of RHS columns")
    rank, _ = comm.rank_and_size(group)
    halo = max(abs(int(o)) for o in offsets)
    n_local = b_local.shape[0]
    dt = b_local.dtype
    if n_local < 2 * halo:
        raise ValueError(
            f"sharded_fused engine: local shard of {n_local} rows is "
            f"narrower than the 2*halo={2 * halo} stencil reach")
    if isinstance(M, str) and M == "jacobi":
        invd = (1.0 / bands_local[list(offsets).index(0)]).to(dt)
        il, ir = halo_exchange_cols(invd, halo, group)
        invd_ext = torch.cat([il, invd, ir])
        # A_hat[i, i+off] = A[i, i+off] * invd[i+off] (column scaling,
        # consistent across rank boundaries through the exchanged rows)
        bands_local = torch.stack([
            bands_local[k] * invd_ext[halo + off:halo + off + n_local]
            for k, off in enumerate(offsets)])
        unscale = invd
    elif M is None:
        unscale = None
    else:
        raise ValueError(
            "sharded pipebicgstab preconditions by folding Jacobi into "
            f"the bands: M must be None or 'jacobi', got {M!r}")

    # loop-invariant operator extension: one exchange per solve
    bl, br = halo_exchange_cols(bands_local, halo, group)
    bands_ext = torch.cat([bl, bands_local, br], dim=-1)
    # this rank's slice of the GLOBAL c = A_hat^T 1, after the Jacobi
    # fold: the set-up row's before any demotion, the sweep's of the
    # operator it streams
    csum = dia_column_checksum(offsets, bands_ext, halo=halo).to(dt)
    sdt = policy.storage_dtype
    sto = dt if sdt is None else sdt
    bands_s = bands_ext.to(sto).contiguous()
    csum_s = dia_column_checksum(offsets, bands_s, halo=halo).to(dt)
    wire_halo = policy.wire == "int8"
    wire_gram = policy.wire_gram == "int8"
    use_ef = policy.error_feedback

    x = torch.zeros_like(b_local)
    r = b_local
    w = dia_matvec_local(offsets, bands_local, r, group)
    t = dia_matvec_local(offsets, bands_local, w, group)
    zero = torch.zeros_like(b_local)
    V0 = torch.stack([r, w, t, zero, zero, r])
    chk0 = torch.zeros((1, 6), dtype=dt, device=b_local.device)
    chk0[0, 0] = torch.sum(t) - torch.sum(csum * w)
    G_loc = torch.cat([V0 @ V0.T, chk0])   # this rank's PARTIAL payload
    r, w, t, zero = (v.to(sto) for v in (r, w, t, zero))
    r_hat, pa, a, c = r, zero, zero, zero
    chk_mask = torch.zeros((7, 6), dtype=torch.bool, device=b_local.device)
    chk_mask[6, 0] = True
    if wire_gram:   # the feedback ``gef`` is read only with use_ef
        G_loc, gef = comp.compress_gram(G_loc, None, preserve=chk_mask)
    if wire_halo:
        efw_l = efw_r = eft_l = eft_r = efc_l = efc_r = torch.zeros(
            (2 * halo,), dtype=sto, device=b_local.device)
    tol2 = torch.as_tensor(tol, dtype=dt, device=b_local.device) ** 2 \
        * comm.all_reduce(torch.sum(b_local * b_local), group)

    reducer = SplitPhaseReduce(group, recorder)
    pending = reducer.issue(G_loc, iteration=-1)
    one = torch.ones((), dtype=dt, device=b_local.device)
    rho_prev = alpha_prev = omega_prev = one
    done = torch.zeros((), dtype=torch.bool, device=b_local.device)
    iters = torch.zeros((), dtype=torch.int32, device=b_local.device)
    eps = _eps(dt)
    hist, chk_hist = [], []
    for i in range(maxiter):
        # 1. strips for THIS iteration's sweep: carried vectors only
        # (the three vectors' strips in one message a neighbour)
        if wire_halo:
            ((wl, wr, efw_l, efw_r), (tl, tr, eft_l, eft_r),
             (cl, cr, efc_l, efc_r)) = halo_exchange_compressed(
                [w, t, c], 2 * halo, group, [efw_l, eft_l, efc_l],
                [efw_r, eft_r, efc_r], use_ef)
        else:
            (wl, wr), (tl, tr), (cl, cr) = halo_exchange_cols(
                [w, t, c], 2 * halo, group)
        if recorder is not None:
            recorder("halo", i)
        # 2. finish the payload issued LAST iteration; its only consumers
        # are the scalar recurrences below
        G = pending.wait()
        rr2, rho, alpha, beta, omega = pbicgstab_scalars(
            G, rho_prev, alpha_prev, omega_prev, i == 0, eps)
        x2, r2, w2, t2, pa2, a2, c2, G_new = kops.pipebicgstab_halo_step(
            offsets, bands_s, csum_s, x, r, w, t, pa, a, c, r_hat,
            wl, wr, tl, tr, cl, cr, alpha, beta, omega)
        if recorder is not None:
            recorder("launch", i)
        if wire_gram:
            G_new, gef = comp.compress_gram(
                G_new, gef if use_ef else None, preserve=chk_mask)
        if noise is not None:
            # the stall delays this rank's contribution; a fault's tick
            # rides the payload into the reduction
            G_new = _tick(noise, rank, G_new)

        done = done | (rr2 <= tol2)
        if not policy.is_default:
            # low-precision breakdown guard: freeze at the last good
            # iterate instead of carrying NaN
            done = done | ~(torch.isfinite(rr2) & torch.isfinite(alpha)
                            & torch.isfinite(omega))
        # freeze AT the iterate whose residual met the tolerance, as the
        # local pipebicgstab does
        x, r, w, t, pa, a, c, G_loc, rho_prev, alpha_prev, omega_prev = (
            torch.where(done, ov, nv) for nv, ov in
            ((x2, x), (r2, r), (w2, w), (t2, t), (pa2, pa), (a2, a),
             (c2, c), (G_new, G_loc), (rho, rho_prev),
             (alpha, alpha_prev), (omega, omega_prev)))
        iters = iters + (~done).to(torch.int32)
        pending = reducer.issue(G_loc, iteration=i)
        hist.append(torch.sqrt(torch.clamp(rr2, min=0.0)))
        chk_hist.append(G[6, 0])

    G_fin = pending.wait()
    res = torch.sqrt(torch.clamp(G_fin[0, 0], min=0.0))
    if maxiter:
        # roll the shifted history into hist[i] = ||r_{i+1}||
        hist = torch.stack(hist[1:] + [res])
        chk_hist = torch.stack(chk_hist[1:] + [G_fin[6, 0]])
    else:
        hist = chk_hist = torch.zeros((0,), dtype=dt, device=b_local.device)
    x_out = x if unscale is None else x * unscale
    return SolveResult(x=x_out, iters=iters, res_norm=res,
                       res_history=hist, detect_history=chk_hist)


# ---------------------------------------------------------------------------
# Sharded depth-l PIPECG: one l*h strip exchange + ONE all-reduce per block
# ---------------------------------------------------------------------------

def sharded_pipecg_depth_solve(offsets: Tuple[int, ...], bands_local,
                               b_local, *, l: int, group=None, M=None,
                               maxiter: int = 100, tol: float = 0.0,
                               noise=None, precision=None, recorder=None
                               ) -> SolveResult:
    """Per-rank depth-l pipelined CG body (ghost-basis blocks).

    Each block of ``l`` iterations is, in this order:

    1. ONE exchange of l*h-wide edge strips of p and of r;
    2. ONE ghost-chain sweep (``kops.ghost_chain_halo_step``) giving the
       (2l+1, n_local) basis and this rank's partial Gram;
    3. ``noise`` (if any), then ONE all-reduce of the (2l+2, 2l+1)
       payload (the partial Gram plus the ABFT state-deviation row
       ``c^T x + 1^T r``), issued and waited for at once: the block's
       steps need it;
    4. l coefficient-space CG steps (pipeline.py::_block_cg_steps) and
       the block-end reconstruction of x, r and p from the chain.

    Depth amortizes both the collective count (one per l iterations)
    and the message count (one strip pair of width l*h instead of l of
    width 2h).  ``recorder`` (an overlap.OrderRecorder) logs ``halo``,
    ``launch``, ``issue`` and ``wait`` per block, the order
    ``overlap.depth_order_ok`` checks.  The deviation ``1^T (b - A x -
    r)`` of each block comes back as ``detect_history`` (repeated to
    per-iteration length).

    Semantics match ``pipeline.py::pipecg_l`` with ``rr=0``.  Set-up,
    once per solve: theta by an all-reduce MAX of the local row sums;
    ``M="jacobi"`` symmetrized in with one exchange of ``diag^-1/2``;
    the operator extended by l*h rows with one exchange; this rank's
    slice of the global column checksum at full precision.  A bf16/fp8
    ``precision`` then stores p, r, the chain and the operator extension
    narrow, while the links, the Gram and the block recurrences stay at
    b's dtype (the kernel's accumulator).  The Gram is consumed in the
    block that computes it, so the int8 wire (which compresses a carried
    payload) is rejected, as are multi-RHS right-hand sides.
    """
    from repro_torch.core.krylov.pipeline import _block_cg_steps, _shift_matrix
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.checksum import dia_column_checksum

    policy = as_policy(precision)
    if policy.wire != "fp32" or policy.wire_gram != "fp32":
        raise ValueError(
            "the depth-l sharded path exchanges one l*halo strip and "
            "finishes its Gram all-reduce inside the same block: int8 "
            "wire compression applies to the depth-1 pipecg/pipebicgstab "
            "bodies only")
    if b_local.dim() != 1:
        raise ValueError(
            "the depth-l sharded path is single-RHS; use l=1 for the "
            "batched pipecg_multi engine")
    rank, _ = comm.rank_and_size(group)
    halo = max(abs(int(o)) for o in offsets)
    H = l * halo
    n_local = b_local.shape[0]
    dt, dev = b_local.dtype, b_local.device
    if n_local < 2 * H:
        raise ValueError(
            f"sharded depth-l engine: local shard of {n_local} rows is "
            f"narrower than the 2*l*halo={2 * H} chain reach")
    if isinstance(M, str) and M == "jacobi":
        ds = 1.0 / torch.sqrt(bands_local[list(offsets).index(0)].to(dt))
        dl, dr = halo_exchange_cols(ds, halo, group)
        ds_ext = torch.cat([dl, ds, dr])
        bands_local = torch.stack([
            bands_local[k] * ds * ds_ext[halo + off:halo + off + n_local]
            for k, off in enumerate(offsets)])
        b_local = b_local * ds
        unscale = ds
    elif M is None:
        unscale = None
    else:
        raise ValueError(
            "sharded depth-l engine preconditions via the symmetrized "
            f"operator: M must be None or 'jacobi', got {M!r}")
    theta = comm.all_reduce(
        torch.max(torch.sum(torch.abs(bands_local), dim=0)), group, op="max")

    # loop-invariant operator extension (+l*h), one exchange per solve
    bl, br = halo_exchange_cols(bands_local, H, group)
    bands_ext = torch.cat([bl, bands_local, br], dim=-1)
    # this rank's slice of the GLOBAL column checksum of the (possibly
    # symmetrized) operator, before any demotion
    csum_loc = dia_column_checksum(offsets, bands_ext, halo=H).to(dt)
    sdt = policy.storage_dtype
    if sdt is not None:
        bands_ext = bands_ext.to(sdt)
    bands_ext = bands_ext.contiguous()

    x = torch.zeros_like(b_local)
    r = b_local if sdt is None else b_local.to(sdt)
    p = r
    m = 2 * l + 1
    Tm = _shift_matrix(l, dt, dev)
    nblocks = -(-maxiter // l)
    # one set-up all-reduce covers the tolerance scale and the 1^T b leg
    # of the deviation detector
    bb, bsum = comm.all_reduce(torch.stack([torch.sum(b_local * b_local),
                                            torch.sum(b_local)]), group)
    tol2 = torch.as_tensor(tol, dtype=dt, device=dev) ** 2 * bb
    reducer = SplitPhaseReduce(group, recorder)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    step = torch.tensor(l, dtype=torch.int32, device=dev)
    hists, dets = [], []
    for bi in range(nblocks):
        # 1. ONE strip exchange per block, of the carried vectors only
        (pl_, pr_), (rl_, rr_) = halo_exchange_cols([p, r], H, group)
        if recorder is not None:
            recorder("halo", bi)
        # 2. the chain and this rank's partial Gram
        C, gram = kops.ghost_chain_halo_step(
            offsets, bands_ext, p, r, pl_, pr_, rl_, rr_, theta, l,
            accum_dtype=None if sdt is None else dt)
        if recorder is not None:
            recorder("launch", bi)
        # 3. the block's one reduction; the deviation partial rides it as
        # an extra row, so a corrupted payload corrupts the detector too
        dev_row = torch.zeros((1, m), dtype=dt, device=dev)
        dev_row[0, 0] = torch.sum(csum_loc * x) + torch.sum(r.to(dt))
        payload = torch.cat([gram, dev_row])
        if noise is not None:
            # the stall delays this rank's contribution; a fault's tick
            # rides the payload into the reduction
            payload = _tick(noise, rank, payload)
        Ge = reducer.issue(payload, iteration=bi).wait()
        G = Ge[:-1]
        dets.append(bsum - Ge[-1, 0])
        # 4. l steps in coefficient space; the carried r and p re-demote
        xc, rc, pc, hist = _block_cg_steps(G, Tm, l, theta, done)
        Cw = C.to(dt)
        x = torch.where(done, x, x + xc @ Cw)
        r = torch.where(done, r, (rc @ Cw).to(r.dtype))
        p = torch.where(done, p, (pc @ Cw).to(p.dtype))
        rr2 = torch.clamp(rc @ G @ rc, min=0.0)   # global: G is
        hists.append(torch.where(done, torch.sqrt(rr2), hist))
        iters = iters + torch.where(done, torch.zeros_like(step), step)
        done = done | (rr2 <= tol2)
    if nblocks:
        hist = torch.cat(hists)[:maxiter]
        det = torch.repeat_interleave(torch.stack(dets), l)[:maxiter]
    else:
        hist = det = torch.zeros((0,), dtype=dt, device=dev)
    r_fin = r.to(dt)
    res = torch.sqrt(torch.clamp(comm.all_reduce(torch.sum(r_fin * r_fin),
                                                 group), min=0.0))
    x_out = x if unscale is None else x * unscale
    return SolveResult(x=x_out, iters=torch.clamp(iters, max=maxiter),
                       res_norm=res, res_history=hist, detect_history=det)


# ---------------------------------------------------------------------------
# Plain-torch split-phase PIPECG bodies: BSR on a chain, DIA on a 2-D grid
# ---------------------------------------------------------------------------

def _recompute_pipecg(b_local, invd, csum, mv, exchange, sweep, *, group,
                      maxiter: int, tol: float, noise, recorder
                      ) -> SolveResult:
    """The split-phase PIPECG loop the BSR-chain and 2-D-grid bodies share.

    Single right-hand side, ``b_local`` this rank's block of any shape;
    ``invd`` and ``csum`` (this rank's slice of the GLOBAL c = A^T 1) have
    its shape.  ``mv(v)`` is this rank's rows of ``A v`` (set-up only);
    ``exchange(u, p)`` returns u and p extended by twice the operator's
    reach (the strips of the neighbours); ``sweep(u_e, p_e, alpha, beta)``
    returns ``(p', s', u', w')`` on this rank's rows, contracting the
    extension as p' = u + beta p -> s' = A p' -> u' = u - alpha diag^-1 s'
    -> w' = A u' (the recompute that spares a second exchange).  Per
    iteration, in the order of :func:`sharded_pipecg_solve`: the exchange
    (recorder ``halo``), the wait for the (6,) row issued last iteration
    (``wait``), the recurrence, the sweep (``launch``), ``noise``, then the
    issue of this iteration's row (``issue``): one all-reduce per
    iteration, H5.  The history is rolled into the local solvers'
    alignment, the checksum column with it as ``detect_history``.
    """
    rank, _ = comm.rank_and_size(group)
    dt, dev = b_local.dtype, b_local.device

    def partials(r, u, w):
        return torch.stack([torch.sum(r * u), torch.sum(w * u),
                            torch.sum(r * r), torch.sum(r * w),
                            torch.sum(w * w),
                            torch.sum(w) - torch.sum(csum * u)])

    x = torch.zeros_like(b_local)
    r = b_local
    u = invd * r
    p = torch.zeros_like(b_local)
    red = partials(r, u, mv(u))
    tol2 = torch.as_tensor(tol, dtype=dt, device=dev) ** 2 \
        * comm.all_reduce(torch.sum(b_local * b_local), group)
    reducer = SplitPhaseReduce(group, recorder)
    pending = reducer.issue(red, iteration=-1)
    one = torch.ones((), dtype=dt, device=dev)
    gamma_prev, alpha_prev = one, one
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    hist, chk_hist = [], []
    for i in range(maxiter):
        u_e, p_e = exchange(u, p)
        if recorder is not None:
            recorder("halo", i)
        red_sum = pending.wait()
        gamma, delta, rr = red_sum[0], red_sum[1], red_sum[2]
        if i == 0:
            beta = torch.zeros_like(gamma)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_prev
            alpha = gamma / (delta - beta * gamma / alpha_prev)
        p2, s2, u2, w2 = sweep(u_e, p_e, alpha, beta)
        x2 = x + alpha * p2
        r2 = r - alpha * s2
        red_new = partials(r2, u2, w2)
        if recorder is not None:
            recorder("launch", i)
        if noise is not None:
            # the stall delays this rank's contribution; a fault's tick
            # rides the row into the reduction
            red_new = _tick(noise, rank, red_new)
        mask = done
        done = mask | (rr <= tol2)
        x, r, u, p, red, gamma_prev, alpha_prev = (
            torch.where(mask, ov, nv) for nv, ov in
            ((x2, x), (r2, r), (u2, u), (p2, p), (red_new, red),
             (gamma, gamma_prev), (alpha, alpha_prev)))
        iters = iters + (~done).to(torch.int32)
        pending = reducer.issue(red, iteration=i)
        hist.append(torch.sqrt(torch.clamp(rr, min=0.0)))
        chk_hist.append(red_sum[5])

    red_fin = pending.wait()
    res = torch.sqrt(torch.clamp(red_fin[2], min=0.0))
    if maxiter:
        hist = torch.stack(hist[1:] + [res])
        chk_hist = torch.stack(chk_hist[1:] + [red_fin[5]])
    else:
        hist = chk_hist = torch.zeros((0,), dtype=dt, device=dev)
    return SolveResult(x=x, iters=iters, res_norm=res, res_history=hist,
                       detect_history=chk_hist)


def _sweep_invd(M, b_local, diag: Callable[[], torch.Tensor],
                what: str) -> torch.Tensor:
    """diag^-1 (``diag()`` gives the local diagonal) for M="jacobi", ones
    for M=None: the bodies precondition in their sweep."""
    if M is None:
        return torch.ones_like(b_local)
    if isinstance(M, str) and M == "jacobi":
        return 1.0 / diag().to(b_local.dtype)
    raise ValueError(f"{what} preconditions in the sweep: M must be None "
                     f"or 'jacobi', got {M!r}")


def _bsr_apply(boffs, bblocks_e: torch.Tensor, v_e: torch.Tensor,
               hb: int) -> torch.Tensor:
    """Block-banded ``y = A v`` on a halo-extended block-row range.

    ``bblocks_e`` (n_boff, obr, bs, bs) holds the blocks of the OUTPUT
    block rows (``BsrMatrix.block_bands``) and ``v_e`` (obr + 2 hb, bs)
    the input extended ``hb`` block rows beyond them:
    ``y[i] = sum_m bblocks_e[m, i] @ v_e[i + hb + boffs[m]]``.
    """
    obr = bblocks_e.shape[1]
    y = torch.zeros((obr, v_e.shape[-1]), dtype=v_e.dtype,
                    device=v_e.device)
    for m, off in enumerate(boffs):
        y = y + torch.einsum("rij,rj->ri", bblocks_e[m],
                             v_e[hb + off:hb + off + obr])
    return y


def _bsr_column_checksum_local(boffs, bblocks_e: torch.Tensor,
                               hb: int) -> torch.Tensor:
    """This rank's (lbr, bs) slice of the GLOBAL column sums A^T 1.

    Block column j is written by block row j - boffs[m], whose blocks lie
    inside the hb-extended local block bands: a gather in offset order,
    no scatter and no communication.
    """
    lbr = bblocks_e.shape[1] - 2 * hb
    colsums = bblocks_e.sum(dim=-2)               # (n_boff, lbr + 2hb, bs)
    c = torch.zeros((lbr, bblocks_e.shape[-1]), dtype=bblocks_e.dtype,
                    device=bblocks_e.device)
    for m, off in enumerate(boffs):
        c = c + colsums[m, hb - off:hb - off + lbr]
    return c


def sharded_pipecg_bsr_solve(boffs, bblocks_local, b_local, *, group=None,
                             ip: str = "id", M=None, maxiter: int = 100,
                             tol: float = 0.0, noise=None, recorder=None
                             ) -> SolveResult:
    """Per-rank PIPECG body for a BSR operator, sharded on block rows.

    ``_engine_solve_bsr`` hands each rank its block rows of the block-DIA form
    (``BsrMatrix.block_bands``: static block offsets ``boffs`` and
    (n_boff, lbr, bs, bs) dense blocks) and of ``b`` as (lbr, bs).  The
    halo is ``hb = max|boffs|`` block rows: the operator and diag^-1 are
    extended by hb once per solve, u and p travel at 2 hb every
    iteration, and the split-phase loop is :func:`_recompute_pipecg`'s.
    Single right-hand side, PIPECG only (``ip="id"``), ``M`` None or
    "jacobi"; plain torch, as the JAX package's body is plain jnp.
    """
    if ip != "id":
        raise ValueError("the sharded BSR body implements the pipecg ('id') "
                         f"inner-product pairing only; got ip={ip!r}")
    if b_local.dim() != 2:
        raise ValueError("sharded_pipecg_bsr_solve is single-RHS: b_local "
                         "must be this rank's (lbr, bs) block rows, got "
                         f"shape {tuple(b_local.shape)}")
    hb = max(abs(int(o)) for o in boffs)
    lbr = b_local.shape[0]
    dt = b_local.dtype
    if lbr < 2 * hb:
        raise ValueError(f"sharded BSR engine: local shard of {lbr} block "
                         f"rows is narrower than the 2*hb={2 * hb} reach")
    invd = _sweep_invd(M, b_local, lambda: torch.diagonal(
        bblocks_local[list(boffs).index(0)], dim1=-2, dim2=-1),
        "the sharded BSR engine")

    def ext(v, w, axis):
        lo, hi = _chain_exchange(v, w, axis, group)
        return torch.cat([lo, v, hi], dim=axis)

    # loop-invariant operator extension: one exchange per solve
    bblocks_h = ext(bblocks_local, hb, -3)
    invd_h = ext(invd, hb, -2)
    csum = _bsr_column_checksum_local(boffs, bblocks_h, hb).to(dt)

    def crop(v, c):
        return v[c:v.shape[0] - c]

    def mv(v):
        return _bsr_apply(boffs, bblocks_local, ext(v, hb, -2), hb)

    def exchange(u, p):
        (ul, uh), (pl, ph) = _chain_exchange([u, p], 2 * hb, -2, group)
        return (torch.cat([ul, u, uh], dim=-2),
                torch.cat([pl, p, ph], dim=-2))

    def sweep(u_e, p_e, alpha, beta):
        pp_e = u_e + beta * p_e                        # extent 2hb
        s_e = _bsr_apply(boffs, bblocks_h, pp_e, hb)   # extent hb
        u2_e = crop(u_e, hb) - alpha * (invd_h * s_e)
        w2 = _bsr_apply(boffs, bblocks_local, u2_e, hb)
        return crop(pp_e, 2 * hb), crop(s_e, hb), crop(u2_e, hb), w2

    return _recompute_pipecg(b_local, invd, csum, mv, exchange, sweep,
                             group=group, maxiter=maxiter, tol=tol,
                             noise=noise, recorder=recorder)


def _grid_neighbours(group, grid: Tuple[int, int]):
    """((north, south), (west, east)) group ranks of this rank on the
    row-major ``(py, px)`` grid; None past the grid's edge."""
    rank, _ = comm.rank_and_size(group)
    py, px = grid
    gy, gx = divmod(rank, px)
    return ((rank - px if gy > 0 else None,
             rank + px if gy < py - 1 else None),
            (rank - 1 if gx > 0 else None,
             rank + 1 if gx < px - 1 else None))


def halo_exchange_2d(v, wy: int, wx: int, grid: Tuple[int, int],
                     group=None):
    """Two-phase, corner-carrying halo exchange on a 2-D process grid.

    ``v`` is (..., ly, lx), this rank's tile of a (ny, nx) field.  Phase 1
    exchanges N/S row strips of width ``wy``; phase 2 exchanges W/E column
    strips of width ``wx`` of the ROW-EXTENDED tile, so the corners ride
    through the edge neighbours: 4 messages per field and no diagonal one
    (``HaloSpec.neighbors``).  Returns the (..., ly + 2 wy, lx + 2 wx)
    extension, zeros past the grid's edge.  A list of fields of one shape
    exchanges in one message a neighbour and phase, and gives a list.
    """
    many = isinstance(v, (list, tuple))
    vs = list(v) if many else [v]
    (north, south), (west, east) = _grid_neighbours(group, grid)
    vs = [torch.cat([n_, x, s_], dim=-2) for x, (n_, s_) in
          zip(vs, comm.exchange_along(vs, wy, -2, north, south, group))]
    vs = [torch.cat([w_, x, e_], dim=-1) for x, (w_, e_) in
          zip(vs, comm.exchange_along(vs, wx, -1, west, east, group))]
    return vs if many else vs[0]


def _apply2d(doffs, bands_e: torch.Tensor, v_e: torch.Tensor,
             hy: int, hx: int) -> torch.Tensor:
    """Stencil ``y = A v`` on a (possibly halo-extended) 2-D tile.

    ``doffs`` are the bands' (dy, dx) lattice steps
    (``DiaMatrix.grid_offsets``); ``bands_e`` (nb, oy, ox) holds the band
    values at the OUTPUT rows and ``v_e`` (oy + 2 hy, ox + 2 hx) the input
    extended beyond them:
    ``y[i, j] = sum_k bands_e[k, i, j] * v_e[i + hy + dy_k, j + hx + dx_k]``.
    """
    oy, ox = bands_e.shape[-2], bands_e.shape[-1]
    y = torch.zeros((oy, ox), dtype=v_e.dtype, device=v_e.device)
    for k, (dy, dx) in enumerate(doffs):
        y = y + bands_e[k] * v_e[hy + dy:hy + dy + oy, hx + dx:hx + dx + ox]
    return y


def _dia2d_column_checksum(doffs, bands_e: torch.Tensor, hy: int,
                           hx: int) -> torch.Tensor:
    """This rank's (ly, lx) slice of the GLOBAL column sums A^T 1.

    Column (i, j) is written by row (i - dy, j - dx) of band k, and every
    such row lies inside the (hy, hx)-extended local bands.
    """
    ly, lx = bands_e.shape[-2] - 2 * hy, bands_e.shape[-1] - 2 * hx
    c = torch.zeros((ly, lx), dtype=bands_e.dtype, device=bands_e.device)
    for k, (dy, dx) in enumerate(doffs):
        c = c + bands_e[k, hy - dy:hy - dy + ly, hx - dx:hx - dx + lx]
    return c


def _crop2d(v: torch.Tensor, cy: int, cx: int) -> torch.Tensor:
    """Drop a (cy, cx)-wide frame from the trailing two axes."""
    return v[..., cy:v.shape[-2] - cy, cx:v.shape[-1] - cx]


def sharded_pipecg_solve_2d(doffs, bands_local, b_local, *,
                            grid: Tuple[int, int], group=None,
                            ip: str = "id", M=None, maxiter: int = 100,
                            tol: float = 0.0, noise=None, recorder=None
                            ) -> SolveResult:
    """Per-rank PIPECG body on a ``(py, px)`` grid of ranks.

    Each rank holds an (ly, lx) tile of the (ny, nx) lattice: ``b_local``
    and ``bands_local`` (nb, ly, lx).  The chain body's W/E strip pair
    becomes the N/S/W/E exchange of :func:`halo_exchange_2d`: the operator
    and diag^-1 extend by (hy, hx) once per solve, u and p by (2 hy, 2 hx)
    every iteration, and the split-phase loop is
    :func:`_recompute_pipecg`'s, its one all-reduce spanning the whole
    grid.  Single right-hand side, PIPECG only (``ip="id"``), ``M`` None
    or "jacobi"; plain torch, as the JAX package's body is plain jnp.
    """
    if ip != "id":
        raise ValueError("the 2-D grid body implements the pipecg ('id') "
                         f"inner-product pairing only; got ip={ip!r}")
    if b_local.dim() != 2:
        raise ValueError("sharded_pipecg_solve_2d is single-RHS: b_local "
                         "must be this rank's (ly, lx) tile, got shape "
                         f"{tuple(b_local.shape)}")
    hy = max(abs(dy) for dy, _ in doffs)
    hx = max(abs(dx) for _, dx in doffs)
    ly, lx = b_local.shape
    dt = b_local.dtype
    if ly < 2 * hy or lx < 2 * hx:
        raise ValueError(f"2-D grid engine: local tile ({ly}, {lx}) is "
                         f"narrower than the (2*hy, 2*hx) = ({2 * hy}, "
                         f"{2 * hx}) stencil reach")
    invd = _sweep_invd(M, b_local,
                       lambda: bands_local[list(doffs).index((0, 0))],
                       "the 2-D grid engine")
    bands_h = halo_exchange_2d(bands_local, hy, hx, grid, group)
    invd_h = halo_exchange_2d(invd, hy, hx, grid, group)
    csum = _dia2d_column_checksum(doffs, bands_h, hy, hx).to(dt)

    def mv(v):
        return _apply2d(doffs, bands_local,
                        halo_exchange_2d(v, hy, hx, grid, group), hy, hx)

    def exchange(u, p):
        u_e, p_e = halo_exchange_2d([u, p], 2 * hy, 2 * hx, grid, group)
        return u_e, p_e

    def sweep(u_e, p_e, alpha, beta):
        pp_e = u_e + beta * p_e                          # extent 2h
        s_e = _apply2d(doffs, bands_h, pp_e, hy, hx)     # extent h
        u2_e = _crop2d(u_e, hy, hx) - alpha * (invd_h * s_e)
        w2 = _apply2d(doffs, bands_local, u2_e, hy, hx)
        return (_crop2d(pp_e, 2 * hy, 2 * hx), _crop2d(s_e, hy, hx),
                _crop2d(u2_e, hy, hx), w2)

    return _recompute_pipecg(b_local, invd, csum, mv, exchange, sweep,
                             group=group, maxiter=maxiter, tol=tol,
                             noise=noise, recorder=recorder)


def _group_and_grid(group):
    """``(process_group, (py, px) or None)`` from ``distributed_solve``'s
    ``group``: one process group (a chain), or such a group and a grid
    shape whose ``py * px`` is the group's size."""
    if not isinstance(group, (tuple, list)):
        return group, None
    pg, grid = group if len(group) == 2 else (None, None)
    if not (isinstance(grid, (tuple, list)) and len(grid) == 2
            and all(isinstance(g, int) and g >= 1 for g in grid)):
        raise ValueError("a 2-D process grid is group=(process_group, "
                         f"(py, px)) with positive ints; got {group!r}")
    _, world = comm.rank_and_size(pg)
    if grid[0] * grid[1] != world:
        raise ValueError(f"a {tuple(grid)} grid needs {grid[0] * grid[1]} "
                         f"ranks; the group has {world}")
    return pg, (grid[0], grid[1])


def _rows(n: int, group) -> slice:
    """This rank's contiguous block of the n rows (even split)."""
    rank, world = comm.rank_and_size(group)
    if n % world:
        raise ValueError(f"{n} rows do not shard evenly over {world} ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


def _gather_x(res: SolveResult, group) -> SolveResult:
    """The result with ``x`` gathered into the global vector."""
    return res._replace(x=comm.all_gather_cols(res.x, group))


def _pop_basic_kw(solver_kw, path: str):
    """(M, maxiter, tol) of a plain-torch body; raises for what it lacks.

    The BSR-chain and 2-D-grid bodies are depth 1 at the solve dtype:
    ``l > 1`` and a non-default precision raise ValueError, any other
    keyword (a warm start, say) TypeError.
    """
    M = solver_kw.pop("M", None)
    maxiter = solver_kw.pop("maxiter", 100)
    tol = solver_kw.pop("tol", 0.0)
    depth = int(solver_kw.pop("l", 1))
    if depth > 1:
        raise ValueError(
            f"the {path} sharded body is depth-1 only (got l={depth}); "
            "depth-l ghost blocks are implemented for the 1-D DIA path")
    if not as_policy(solver_kw.pop("precision", None)).is_default:
        raise ValueError(
            f"the {path} sharded body runs at the solve dtype only; "
            "mixed-precision policies are implemented for the 1-D DIA path")
    if solver_kw:
        raise TypeError(f"unsupported kwargs for the {path} sharded path: "
                        f"{sorted(solver_kw)}")
    return M, maxiter, tol


def _engine_solve_bsr(name, A, b, group, eng, *, grid=None, noise=None,
                      recorder=None, **solver_kw) -> SolveResult:
    """Drive :func:`sharded_pipecg_bsr_solve` over the block rows.

    The block-DIA form (``BsrMatrix.block_bands``) is taken once; each
    rank gets its contiguous block rows of it and of ``b`` as (nbr, bs).
    """
    if grid is not None:
        raise ValueError(
            "the sharded BSR body shards block rows over a chain of ranks; "
            "pass one process group, not a (py, px) grid")
    if name != "pipecg":
        raise ValueError(
            f"the sharded BSR body implements pipecg only; got {name!r}")
    if b.dim() != 1:
        raise ValueError("the sharded BSR body is single-RHS; got batched b "
                         f"of shape {tuple(b.shape)}")
    M, maxiter, tol = _pop_basic_kw(solver_kw, "BSR")
    sl = _rows(A.n_block_rows, group)
    boffs, bblocks = A.block_bands()
    body = eng.body("pipecg", "bsr")
    res = body(boffs, bblocks[:, sl].contiguous(),
               b.reshape(A.n_block_rows, A.bs)[sl].contiguous(), group=group,
               M=M, maxiter=maxiter, tol=tol, noise=noise,
               recorder=recorder)
    return _gather_x(res._replace(x=res.x.reshape(-1)), group)


def _engine_solve_2d(name, A, b, group, grid, eng, *, noise=None,
                     recorder=None, **solver_kw) -> SolveResult:
    """Drive :func:`sharded_pipecg_solve_2d` over a ``(py, px)`` grid.

    The operator's (ny, nx) lattice (``grid_shape``) is tiled over the
    grid: rank r owns the (ny/py, nx/px) tile at grid position
    ``(r // px, r % px)``, the JAX mesh's ``devices.reshape(py, px)``
    order; the result's ``x`` is gathered back into lattice order.
    """
    if A.grid_shape is None:
        raise ValueError(
            "a (py, px) process grid needs a DiaMatrix built with "
            "grid_shape=(ny, nx) (e.g. operators.laplacian_2d) so its "
            "offsets decompose into (dy, dx) grid displacements")
    if name != "pipecg":
        raise ValueError(
            f"the 2-D grid sharded body implements pipecg only; got {name!r}")
    if b.dim() != 1:
        raise ValueError("the 2-D grid sharded body is single-RHS; got "
                         f"batched b of shape {tuple(b.shape)}")
    M, maxiter, tol = _pop_basic_kw(solver_kw, "2-D grid")
    (ny, nx), (py, px) = A.grid_shape, grid
    if ny % py or nx % px:
        raise ValueError(f"grid {A.grid_shape} does not tile evenly over "
                         f"the ({py}, {px}) process grid")
    rank, _ = comm.rank_and_size(group)
    gy, gx = divmod(rank, px)
    ly, lx = ny // py, nx // px
    rows = slice(gy * ly, (gy + 1) * ly)
    cols = slice(gx * lx, (gx + 1) * lx)
    bands = A.bands.reshape(len(A.offsets), ny, nx)[:, rows, cols]
    body = eng.body("pipecg", "dia2d")
    res = body(A.grid_offsets(), bands.contiguous(),
               b.reshape(ny, nx)[rows, cols].contiguous(), grid=grid,
               group=group, M=M, maxiter=maxiter, tol=tol, noise=noise,
               recorder=recorder)
    tiles = comm.all_gather_cols(res.x.reshape(-1), group)
    x = tiles.reshape(py, px, ly, lx).permute(0, 2, 1, 3).reshape(-1)
    return res._replace(x=x)


def _distributed_engine_solve(solver, A, b, group, eng, *, grid=None,
                              noise=None, recorder=None, **solver_kw
                              ) -> SolveResult:
    """The ShardedFusedEngine path, routed on the operator's format and
    the process grid: a BsrMatrix to the BSR body on a chain of ranks, a
    DiaMatrix with a ``(py, px)`` grid to the 2-D body, else the 1-D DIA
    bodies (through ``ShardedFusedEngine.body``)."""
    name = getattr(solver, "__name__", str(solver))
    family = "pipecg" if name in _SHARDED_IP else _SHARDED_FAMILY.get(name)
    if family is None:
        raise ValueError(
            "engine='sharded_fused' supports pipecg / pipecg_multi / "
            f"pipecr / pipecg_l / pipebicgstab; got solver {name!r}")
    kw = dict(noise=noise, recorder=recorder, **solver_kw)
    if isinstance(A, BsrMatrix):
        return _engine_solve_bsr(name, A, b, group, eng, grid=grid, **kw)
    if not isinstance(A, DiaMatrix):
        raise ValueError(
            "engine='sharded_fused' needs a DiaMatrix or BsrMatrix "
            f"operator; got {type(A).__name__}")
    if grid is not None:
        return _engine_solve_2d(name, A, b, group, grid, eng, **kw)
    body = eng.body(family)
    M = solver_kw.pop("M", None)
    maxiter = solver_kw.pop("maxiter", 100)
    tol = solver_kw.pop("tol", 0.0)
    sl = _rows(A.n, group)
    if family == "pipebicgstab":
        precision = solver_kw.pop("precision", None)
        if {"x0", "carried", "with_state"} & set(solver_kw):
            raise ValueError(
                "x0= / carried= / with_state= (elastic warm start) are "
                "implemented for the pipecg/pipecr body only; the "
                "'pipebicgstab' path cannot resume mid-recurrence")
        if solver_kw:
            raise TypeError("unsupported kwargs for the sharded_fused "
                            f"path: {sorted(solver_kw)}")
        res = body(A.offsets, A.bands[:, sl].contiguous(),
                   b[..., sl].contiguous(), group=group, M=M,
                   maxiter=maxiter, tol=tol, noise=noise,
                   precision=precision, recorder=recorder)
        return _gather_x(res, group)
    depth = int(solver_kw.pop("l", 1))
    if depth > 1 and name != "pipecg_l":
        raise ValueError(
            f"pipeline depth l={depth} needs solver pipecg_l, got {name!r}")
    precision = solver_kw.pop("precision", None)
    warm = {kw: solver_kw.pop(kw) for kw in ("x0", "carried", "with_state")
            if kw in solver_kw}
    if family == "pipecg_l" and depth > 1:
        if warm:
            raise ValueError(
                "x0= / carried= / with_state= (elastic warm start) are "
                "implemented for the depth-1 pipecg/pipecr body only; the "
                f"'pipecg_l' (l={depth}) path cannot resume mid-recurrence")
        if solver_kw:
            raise TypeError("unsupported kwargs for the sharded_fused "
                            f"path: {sorted(solver_kw)}")
        res = body(A.offsets, A.bands[:, sl].contiguous(),
                   b[..., sl].contiguous(), l=depth, group=group, M=M,
                   maxiter=maxiter, tol=tol, noise=noise,
                   precision=precision, recorder=recorder)
        return _gather_x(res, group)
    if family == "pipecg_l":   # depth 1: the PIPECG body itself
        body = eng.body("pipecg")
    if solver_kw:
        raise TypeError("unsupported kwargs for the sharded_fused path: "
                        f"{sorted(solver_kw)}")
    # the warm start's vectors are global: each rank takes its rows, and
    # the recurrence scalars go whole
    if warm.get("x0") is not None:
        warm["x0"] = torch.as_tensor(warm["x0"], device=b.device)[
            ..., sl].contiguous()
    if warm.get("carried") is not None:
        warm["carried"] = {
            k: (v[..., sl].contiguous() if v.dim() == 2 else v)
            for k, v in ((k, torch.as_tensor(v, device=b.device))
                         for k, v in warm["carried"].items())}
    out = body(A.offsets, A.bands[:, sl].contiguous(),
               b[..., sl].contiguous(), group=group,
               ip=_SHARDED_IP.get(name, "id"),
               M=M, maxiter=maxiter, tol=tol, noise=noise,
               precision=precision, recorder=recorder, **warm)
    if not warm.get("with_state"):
        return _gather_x(out, group)
    res, state = out
    # gathered to global (k, n) tensors, so that any group can take it
    return _gather_x(res, group), {
        k: (comm.all_gather_cols(v, group) if v.dim() == 2 else v)
        for k, v in state.items()}


def distributed_solve(solver: Callable, A, b: torch.Tensor,
                      group=None, *, use_kernel: bool = False, noise=None,
                      engine=None, options=None, recorder=None,
                      **solver_kw) -> SolveResult:
    """Run ``solver`` (cg / cr / pipecg / pipecr / pipecg_multi / gmres /
    pgmres / bicgstab / pipebicgstab / pipecg_l) with the rows of ``A`` and
    ``b`` split over the ranks of ``group``.

    Every rank of the group calls it with the same global ``A`` and ``b``
    and gets the same result, ``x`` global.  ``engine=None`` keeps the
    historical per-op iteration (any solver taking ``dot=``; gmres and
    pgmres take ``restart=``, and pgmres finishes its line-18 batch with
    one all-reduce); ``use_kernel`` applies each rank's bands there with
    the extended-x SpMV kernel (:func:`dia_matvec_local`);
    ``"sharded_fused"`` (or a ShardedFusedEngine) runs pipecg /
    pipecg_multi / pipecr / pipebicgstab as one halo sweep per rank per
    iteration with a split-phase all-reduce (:func:`sharded_pipecg_solve`,
    :func:`sharded_pipebicgstab_solve`), and pipecg_l (``l=``) as one
    chain sweep and one all-reduce per block
    (:func:`sharded_pipecg_depth_solve`); ``recorder`` logs their order.
    A ``BsrMatrix`` runs pipecg on its block rows over the chain of ranks
    (:func:`sharded_pipecg_bsr_solve`, sharded engine only).
    ``group=(process_group, (py, px))`` lays the group's ranks on a
    row-major ``(py, px)`` grid (rank r at ``(r // px, r % px)``): the
    sharded engine then runs pipecg on a DiaMatrix with ``grid_shape``
    tile by tile (:func:`sharded_pipecg_solve_2d`, N/S/W/E strips), the
    inline path on the flattened chain.  The BSR and 2-D bodies are plain
    torch, single-RHS, depth 1 at the solve dtype.  ``options`` (a
    SolverOptions) bundles engine, maxiter/tol, M, depth, noise and
    precision; it cannot be mixed with the loose spellings.
    ``precision`` needs the sharded engine.  The depth-1 PIPECG/PIPECR
    body also takes ``x0=`` (a global iterate to restart from),
    ``carried=`` (a global state to continue from exactly) and
    ``with_state=True``, which returns ``(result, state)`` with the state
    gathered to global tensors, so that a group of another size can take
    it (:func:`sharded_pipecg_solve`).
    """
    from repro_torch.core.krylov.engine import ShardedFusedEngine, get_engine

    group, grid = _group_and_grid(group)
    if options is not None:
        if not isinstance(options, SolverOptions):
            raise TypeError(
                "options= must be a SolverOptions; got "
                f"{type(options).__name__}")
        clashes = [kw for kw in ("maxiter", "tol", "M", "l", "precision")
                   if kw in solver_kw]
        if engine is not None or noise is not None or clashes:
            loose = [kw for kw, v in
                     (("engine", engine), ("noise", noise)) if v is not None]
            raise TypeError(
                "pass the solve configuration either as options= or as "
                "loose kwargs, not both (options= given alongside "
                f"{sorted(loose + clashes)})")
        engine = options.engine
        noise = options.noise
        solver_kw.update(maxiter=options.maxiter, tol=options.tol)
        if options.M is not None:
            solver_kw["M"] = options.M
        if options.depth != 1:
            solver_kw["l"] = options.depth
        if not options.precision.is_default:
            solver_kw["precision"] = options.precision
        if options.rr or options.rr_tau:
            raise ValueError(
                "rr= / rr_tau= (residual replacement) are local-solver "
                "options; the sharded bodies re-glue via x0= restarts")

    eng = get_engine(engine)
    if isinstance(eng, ShardedFusedEngine):
        return _distributed_engine_solve(solver, A, b, group, eng,
                                         grid=grid, noise=noise,
                                         recorder=recorder, **solver_kw)
    if eng is not None:
        raise ValueError(
            "distributed_solve supports engine=None (historical inline "
            "path) or 'sharded_fused'; single-device engines compute "
            f"local reductions and cannot shard (got {eng.name!r})")
    if not isinstance(A, DiaMatrix):
        raise ValueError(
            "the inline path (engine=None) applies DIA bands on every rank; "
            f"a {type(A).__name__} runs under engine='sharded_fused'")
    if getattr(solver, "__name__", "") == "pipecg_l":
        raise ValueError(
            "pipecg_l's ghost-basis blocks need the depth-aware sharded "
            "path: use distributed_solve(pipecg_l, A, b, group, "
            "engine='sharded_fused', l=...); the historical inline path "
            "(engine=None) cannot express its fused Gram reduction")
    if recorder is not None:
        raise ValueError(
            "recorder= logs the sharded body's split-phase order; the "
            "inline path waits for every reduction where it is issued")
    for kw in ("x0", "carried", "with_state"):
        if kw in solver_kw:
            raise ValueError(
                f"{kw}= (elastic warm start) needs engine='sharded_fused'; "
                "the historical inline path cannot resume carried state")
    if not as_policy(solver_kw.pop("precision", None)).is_default:
        raise ValueError(
            "mixed-precision policies (storage demotion / int8 wire) are "
            "implemented by the sharded kernel bodies: use "
            "engine='sharded_fused'; the historical inline path runs at "
            "the solve dtype only")

    rank, _ = comm.rank_and_size(group)
    sl = _rows(A.n, group)
    bands_local = A.bands[:, sl].contiguous()
    b_local = b[..., sl].contiguous()
    offsets = A.offsets

    def mv(v):
        y = dia_matvec_local(offsets, bands_local, v, group,
                             use_kernel=use_kernel)
        if noise is not None:
            y = _tick(noise, rank, y)
        return y

    opts = SolverOptions(**{("depth" if k == "l" else k): solver_kw.pop(k)
                            for k in ("maxiter", "tol", "M", "l")
                            if k in solver_kw})
    if getattr(solver, "__name__", "") == "pipebicgstab":
        # keep the one-reduction-per-iteration structure on the inline
        # path too: finish the locally computed (6, 6) Gram with a single
        # all-reduce instead of 21 per-entry dots
        solver_kw["gram_reduce"] = lambda G: comm.all_reduce(G, group)
    if getattr(solver, "__name__", "") == "pgmres":
        # line 18's (m + 2,) batch is one all-reduce, as the reference's
        # vmap of its psum dot lowers to one psum
        solver_kw["dots_reduce"] = lambda v: comm.all_reduce(v, group)
    res = solver(mv, b_local, dot=make_allreduce_dot(group), options=opts,
                 **solver_kw)
    return _gather_x(res, group)
