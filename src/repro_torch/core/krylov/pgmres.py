"""PGMRES, the paper's Algorithm 2 (Ghysels et al. p(1)-GMRES, SISC 2013).

The pipelined rearrangement delays the normalization of the new basis
vector by ONE iteration: at step i the fused reduction {h_{j,i} =
<z_{i+1}, v_j>, j <= i} (line 18) is started while the SpMV ``w = A z_i``
of the next step proceeds; lines 5-10 then lazily rescale the quantities
that were not yet normalized by h_{i-1,i-2}.  Line 16's norm is the other
reduction of an iteration, so a distributed iteration holds two: the norm
and the batch.

The loop runs ``restart + 2`` iterations (two to fill the pipeline), as
the reference's ``fori_loop``; everything stays on the device.  Line
numbers in comments refer to Algorithm 2 as printed in the paper.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.krylov.base import SolveResult, local_dot
from repro_torch.core.krylov.gmres import (_cycle_operators,
                                           _lstsq_hessenberg,
                                           _one_cycle_options, _residual)
from repro_torch.core.krylov.options import UNSET


def pgmres(A, b, x0=None, *, restart: int = 30, tol=UNSET, M=UNSET,
           dot=local_dot, engine=UNSET, depth=UNSET,
           dots_reduce: Optional[Callable] = None,
           options=None) -> SolveResult:
    """One restart cycle of pipelined GMRES.

    ``engine`` routes the line-18 batch through the engine's one-pass
    multi-dot (kernels/fused_dots.py on the card) and the SpMV through the
    engine; None keeps the inline path that ``distributed_solve`` runs.
    ``dots_reduce`` (inline path only) finishes the locally computed
    (m + 2,) line-18 batch with one collective, as the reference's
    ``vmap`` of its dot lowers to one psum; it defaults to the identity,
    so a custom ``dot`` must come with it.  ``depth >= 2`` routes to the
    ghost-basis variant (core/krylov/pipeline.py::pgmres_l).
    ``options=SolverOptions(...)`` spells ``tol`` / ``M`` / ``engine`` /
    ``depth``; the cycle length is ``restart``, so a non-default
    ``options.maxiter`` raises.
    """
    opts = _one_cycle_options(options, "pgmres", ("engine", "depth"),
                              tol=tol, M=M, engine=engine, depth=depth)
    if opts.depth != 1:
        from repro_torch.core.krylov.pipeline import pgmres_l
        if dot is not local_dot or dots_reduce is not None:
            raise ValueError(
                "depth-l pgmres computes its reductions as fused Gram "
                "blocks and cannot honor a custom dot; use depth=1 there")
        return pgmres_l(A, b, x0, restart=restart, options=opts)
    mv, Mf, eng = _cycle_operators(A, opts.M, dot, opts.engine)
    if eng is not None and dots_reduce is not None:
        raise ValueError("dots_reduce= finishes the inline path's batch; an "
                         "engine computes local reductions")
    if eng is None and dots_reduce is None and dot is not local_dot:
        raise ValueError(
            "a custom dot needs dots_reduce= to finish line 18's batch with "
            "one reduction (distributed_solve passes both)")
    reduce = dots_reduce if dots_reduce is not None else (lambda v: v)

    def batch(V, z):
        """Line 18's (m + 2,) batch <V[j], z> as ONE reduction."""
        if eng is not None:
            return eng.dots(V, z)
        return reduce(torch.sum(V * z, dim=-1))

    x = torch.zeros_like(b) if x0 is None else x0
    m = restart
    n = b.shape[0]
    dt, dev = b.dtype, b.device

    # 1: r0 <- b - A x0;  v0 <- r0/||r0||;  z0 <- v0
    r0 = Mf(b - mv(x))
    beta = torch.sqrt(dot(r0, r0))
    v0 = r0 / beta
    V = torch.zeros((m + 2, n), dtype=dt, device=dev)
    V[0] = v0
    Z = torch.zeros((m + 3, n), dtype=dt, device=dev)
    Z[0] = v0
    H = torch.zeros((m + 3, m + 2), dtype=dt, device=dev)
    dmask = (torch.arange(m + 2, device=dev)[None, :]
             <= torch.arange(m + 2, device=dev)[:, None]).to(dt)

    for i in range(m + 2):
        # 3: w <- A z_i
        w = Mf(mv(Z[i]))
        if i > 1:
            # 4-11: lazy rescale by h_{i-1,i-2} now that its norm is in
            h_prev = H[i - 1, i - 2]
            scale = 1.0 / torch.where(h_prev != 0, h_prev, 1.0)
            V[i - 1] = V[i - 1] * scale                      # 5
            Z[i] = Z[i] * scale                              # 6
            w = w * scale                                    # 7
            H[:i - 1, i - 1] = H[:i - 1, i - 1] * scale      # 8-9
            # 10: both z_i and v_{i-1} were unnormalized in this dot
            H[i - 1, i - 1] = H[i - 1, i - 1] * (scale * scale)
        if i > 0:
            # 12: z_{i+1} <- w - sum_{j<i} h_{j,i-1} z_{j+1}
            coeff = H[:i, i - 1]
            z_next = w - coeff @ Z[1:i + 1]
            # 14-16: v_i <- z_i - sum_{j<i} h_{j,i-1} v_j; h_{i,i-1} <- ||v_i||
            V[i] = Z[i] - coeff @ V[:i]
        else:
            z_next = w
        Z[i + 1] = z_next
        hnorm = torch.sqrt(dot(V[i], V[i]))
        if i > 0:
            H[i, i - 1] = hnorm
        # 18: h_{j,i} <- <z_{i+1}, v_j>, j = 0..i: one batched reduction,
        #     overlapping the next iteration's SpMV on line 3
        H[:m + 2, i] = batch(V, z_next) * dmask[i]

    y = _lstsq_hessenberg(H[:m + 1, :m], beta, m)
    x_final = x + V[:m].T @ y
    return SolveResult(x=x_final,
                       iters=torch.tensor(m, dtype=torch.int32, device=dev),
                       res_norm=_residual(b, mv, x_final, dot),
                       res_history=torch.abs(torch.diagonal(H, -1)[:m]))
