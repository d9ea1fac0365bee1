"""Per-iteration phase model of a distributed Krylov step, linking the
roofline constants of the card to the stochastic makespan model.

Per-iteration phases (the paper's Section 4 decomposition):
  SpMV            - memory-bound stencil: bytes/P / HBM bandwidth
  AXPY / orthog.  - memory-bound vector traffic
  dot reductions  - latency: ~2 log2(P) hops * hop latency (tree/ring)

Classical CG:   2 reduction sync points, NOT overlapped      (Alg. 1)
PIPECG:         1 fused reduction, overlapped with SpMV      (Alg. 4)
  -> t_step_sync  = t_compute + t_red
     t_step_pipe  = max(t_compute, t_red)

``n_reductions`` generalizes the model to s-sync solvers (classical
BiCGStab exposes four sync points per iteration; p-BiCGStab fuses them
into one): the synchronized step pays ``n_red * t_red`` serialized
latencies, the pipelined step at most one overlapped ``t_red``, so in the
latency-dominated regime ``predict_speedup`` reports a ceiling of
``n_red_sync / n_red_pipe``.

``Hardware()`` holds the figures of the card this port runs on, an NVIDIA
H100 SXM (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W"): NVIDIA's data
sheet for the peaks, and a measured NCCL all-reduce for the hop latency.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.perfmodel import comm
from repro_torch.core.perfmodel.distributions import Distribution, Shifted
from repro_torch.core.perfmodel.expected_max import expected_max


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit."""

    # data sheet, dense bf16 on the tensor cores
    peak_flops: float = 989e12        # FLOP/s
    # data sheet, HBM3
    hbm_bw: float = 3.35e12           # B/s
    # data sheet, NVLink 4: 900 GB/s to the host's other cards, 450 each way
    link_bw: float = 450e9            # B/s
    # measured on 4 H100 80GB HBM3 of one host, 700.00 W each: NCCL
    # all-reduce of one float64, host-blocking median 72.0775 us over
    # 2 log2(4) = 4 hops (torch_allreduce_latency.py; PERF.md). Mostly
    # fixed launch and synchronize cost (58.3 us back-to-back, 14.575 a
    # hop), which t_reduction scales by 2 log2 P: large-P speedups are
    # extrapolated from this one host
    hop_latency: float = 1.8019375e-5  # s per collective hop
    # data sheet, float64 outside the tensor cores
    f64_flops: float = 34e12          # FLOP/s


@dataclasses.dataclass(frozen=True)
class SolverPhaseModel:
    """Per-iteration times of a distributed Krylov step on P cards.

    ``storage_words`` / ``wire_words`` are the fp32-equivalent scaling
    factors of a ``PrecisionPolicy`` (core/krylov/options.py): the sweep
    terms scale with the storage width, the halo bytes with the wire
    width.  ``halo`` is the stencil half-bandwidth; 0 leaves the halo
    term out.
    """

    n: int                      # global problem size
    nnz_per_row: int            # 3 for ex23; ~21 for ex48-like band
    p: int                      # number of cards
    dtype_bytes: int = 8
    hw: Hardware = dataclasses.field(default_factory=Hardware)
    n_vec_reads: int = 6        # AXPY traffic multiple (CG)
    n_reductions: int = 2       # sync points per iteration (CG)
    halo: int = 0               # stencil half-bandwidth (wire elements/side)
    n_halo_vecs: int = 2        # vectors exchanged per iteration (u, p)
    storage_words: float = 1.0  # sweep-bytes scale (PrecisionPolicy.storage)
    wire_words: float = 1.0     # halo-bytes scale (PrecisionPolicy.wire)
    grid: tuple = ()            # process grid (py, px); () = 1-D chain of p
    grid_points: tuple = ()     # global lattice extents matching ``grid``

    def t_spmv(self) -> float:
        bytes_local = ((self.nnz_per_row + 2) * self.dtype_bytes
                       * self.storage_words * self.n / self.p)
        return bytes_local / self.hw.hbm_bw

    def t_axpy(self) -> float:
        return (self.n_vec_reads * self.dtype_bytes * self.storage_words
                * self.n / self.p / self.hw.hbm_bw)

    def t_reduction(self) -> float:
        return 2.0 * math.log2(max(self.p, 2)) * self.hw.hop_latency

    def t_halo(self) -> float:
        """Neighbour-exchange time: surface bytes on the link + face hops.

        A data dependence of the local stencil (the split-phase window
        hides the reduction, not this), so it adds to the compute side of
        Eq. 6/7.  Zero without a halo or on one card.  With ``grid`` set
        it follows the surface-to-volume law of core/perfmodel/comm.py.
        """
        if self.halo <= 0 or self.p <= 1:
            return 0.0
        if self.grid:
            if math.prod(self.grid) != self.p:
                raise ValueError(
                    f"process grid {self.grid} does not multiply to "
                    f"p={self.p}")
            extents = comm.local_extents(self.grid_points, self.grid)
            widths = (self.halo,) * len(self.grid)
        else:
            extents = (self.n // self.p,)
            widths = (self.halo,)
        return comm.halo_wire_time(
            extents, widths, n_halo_vecs=self.n_halo_vecs,
            dtype_bytes=self.dtype_bytes, wire_words=self.wire_words,
            link_bw=self.hw.link_bw, hop_latency=self.hw.hop_latency)

    def t_compute(self) -> float:
        return self.t_spmv() + self.t_axpy() + self.t_halo()


def apply_precision(model: SolverPhaseModel, precision) -> SolverPhaseModel:
    """Scale a phase model's sweep and wire byte terms by a policy.

    ``precision`` is a PrecisionPolicy, a preset name, or None (no-op).
    The reduction-latency term is untouched: its payload is a few
    scalars, latency-bound by construction.
    """
    from repro_torch.core.krylov.options import as_policy
    policy = as_policy(precision)
    if policy.is_default:
        return model
    return dataclasses.replace(
        model,
        storage_words=model.storage_words * policy.storage_words,
        wire_words=model.wire_words * policy.wire_words)


def predict_speedup(model_sync: SolverPhaseModel,
                    model_pipe: SolverPhaseModel, noise: Distribution,
                    K: int, depth: int = 1, precision=None, grid=None,
                    grid_points=None, device="cuda") -> Dict[str, float]:
    """E[T]/E[T'] with per-step noise ~ ``noise`` added to each process.

    Synchronized: every step costs max_p(t_c + w_p) + n_red * t_red.
    Pipelined:    reductions overlap compute; per-process accumulation.

    ``depth`` l gives the overlapped reduction l iterations of compute to
    hide behind (its per-iteration floor becomes ``n_red * t_red / l``).
    ``precision`` applies to the PIPELINED model only, the synchronized
    baseline stays full precision.  ``grid`` / ``grid_points`` (both or
    neither) put both models' halo term on a d-dimensional process grid;
    the report then also carries ``halo_msgs`` and ``surface_to_volume``.
    ``device`` evaluates E[max] by quadrature where it has no closed form.
    """
    if grid is not None:
        if grid_points is None:
            raise ValueError("grid= needs grid_points= (the global "
                             "lattice extents)")
        model_sync = dataclasses.replace(model_sync, grid=tuple(grid),
                                         grid_points=tuple(grid_points))
        model_pipe = dataclasses.replace(model_pipe, grid=tuple(grid),
                                         grid_points=tuple(grid_points))
    p = model_sync.p
    model_pipe = apply_precision(model_pipe, precision)
    tc_s = model_sync.t_compute()
    tc_p = model_pipe.t_compute()
    tr = model_sync.t_reduction()

    e_max = expected_max(Shifted(base=noise, loc=tc_s), p, device=device)
    e_t_sync = K * (e_max + model_sync.n_reductions * tr)
    # pipelined: one overlapped reduction per depth-l window; steady
    # state per-process mean
    red_floor = model_pipe.n_reductions * tr / max(depth, 1)
    e_t_pipe = K * max(tc_p + float(noise.mean), red_floor)
    out = {
        "t_sync": e_t_sync,
        "t_pipe": e_t_pipe,
        "speedup": e_t_sync / e_t_pipe,
        "t_spmv": model_sync.t_spmv(),
        "t_reduction": tr,
        "noise_mean": float(noise.mean),
        "e_max_step": e_max,
        "t_pipe_compute": tc_p,
        "t_pipe_halo": model_pipe.t_halo(),
        "pipe_latency_bound": float(red_floor >= tc_p + float(noise.mean)),
    }
    if model_pipe.grid and model_pipe.halo > 0:
        ext = comm.local_extents(model_pipe.grid_points, model_pipe.grid)
        widths = (model_pipe.halo,) * len(model_pipe.grid)
        out["halo_msgs"] = float(comm.halo_messages(len(model_pipe.grid)))
        out["surface_to_volume"] = comm.surface_to_volume(ext, widths)
    return out


def ex23_models(p: int, hw: Hardware = Hardware()
                ) -> Dict[str, SolverPhaseModel]:
    """The paper's ex23 problem: tridiagonal, most time in dot products."""
    from repro_torch.core.noise.traces import EX23_N
    return {
        "cg": SolverPhaseModel(n=EX23_N, nnz_per_row=3, p=p, hw=hw,
                               n_vec_reads=6, n_reductions=2),
        # PIPECG: more AXPY state (z,q,s,p + x,r,u,w) -> ~2x vector traffic
        "pipecg": SolverPhaseModel(n=EX23_N, nnz_per_row=3, p=p, hw=hw,
                                   n_vec_reads=14, n_reductions=1),
        # classical BiCGStab: 2 SpMVs + 4 exposed reductions per iteration
        "bicgstab": SolverPhaseModel(n=EX23_N, nnz_per_row=3, p=p, hw=hw,
                                     n_vec_reads=10, n_reductions=4),
        # p-BiCGStab: the carried w/t/pa/a/c chains roughly double the
        # AXPY traffic; all four reductions fused into ONE overlapped Gram
        "pipebicgstab": SolverPhaseModel(n=EX23_N, nnz_per_row=3, p=p,
                                         hw=hw, n_vec_reads=18,
                                         n_reductions=1),
    }
