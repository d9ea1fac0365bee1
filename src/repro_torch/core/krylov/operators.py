"""Linear operators for the Krylov solvers.

The paper's test problem (PETSc KSP tutorial ex23) is a tridiagonal 1-D
Laplacian of size N = 2,097,152.  Banded matrices are stored in DIA
(diagonal) format — offsets + bands — which maps onto both the plain torch
matvec (shifted adds) and the CUDA stencil kernel (kernels/spmv_dia.py).
Factories default to ``device="cuda"`` and float64; pass ``device="cpu"``
to build on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.krylov.operator import (HaloSpec, SparseOperator,
                                              _sha1_hex16, tensor_bytes)


def dia_gather_matvec(offsets: Sequence[int], bands, x):
    """DIA matvec as one padded copy + an ordered band fold.

    ``y[i] = sum_k bands[k, i] * x[i + offsets[k]]``.  ``x`` is padded by
    the halo on both sides and every band term reads a shifted slice of the
    pad, so out-of-range positions see zeros.  The terms are folded left to
    right in band order, the float addition order of the reference.  ``x``
    may carry leading batch dimensions.
    """
    n = x.shape[-1]
    offs = [int(o) for o in offsets]
    h = max((abs(o) for o in offs), default=0)
    x_ext = F.pad(x, (h, h))
    terms = [bands[k] * x_ext[..., h + o:h + o + n] for k, o in enumerate(offs)]
    y = terms[0]
    for t in terms[1:]:
        y = y + t
    return y


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Banded matrix: ``A[i, i+off] = bands[k, i]`` for ``off = offsets[k]``.

    Entries of a band that would fall outside the matrix must be zero.
    ``grid_shape=(ny, nx)`` may be set by 2-D stencil factories
    (``laplacian_2d``) to declare that the offsets decompose onto a
    row-major lattice, which upgrades ``halo_spec()`` to the 4-neighbor
    N/S/W/E form.
    """

    offsets: Tuple[int, ...]
    bands: torch.Tensor  # (n_bands, N)
    grid_shape: Optional[Tuple[int, int]] = None

    @property
    def n(self) -> int:
        """Global problem size (rows)."""
        return self.bands.shape[1]

    @property
    def halo(self) -> int:
        """Max |offset| — the 1-D halo strip width."""
        return max(abs(o) for o in self.offsets)

    @property
    def dtype(self):
        """Coefficient dtype."""
        return self.bands.dtype

    @property
    def device(self) -> torch.device:
        """Device the bands live on."""
        return self.bands.device

    @property
    def format(self) -> str:
        """Format tag ("dia") for table-driven dispatch."""
        return "dia"

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[i] = sum_k bands[k, i] * x[i + offsets[k]] (plain torch)."""
        return dia_gather_matvec(self.offsets, self.bands, x)

    def diagonal(self) -> torch.Tensor:
        """``diag(A)`` — the offset-0 band."""
        return self.bands[self.offsets.index(0)]

    def to_dense(self) -> torch.Tensor:
        """Dense (n, n) rendering (tests / small problems only)."""
        n = self.n
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        for k, off in enumerate(self.offsets):
            idx = torch.arange(max(0, -off), min(n, n - off),
                               device=self.device)
            A[idx, idx + off] = self.bands[k, idx]
        return A

    def grid_offsets(self) -> Tuple[Tuple[int, int], ...]:
        """Decompose each offset into a (dy, dx) lattice displacement.

        Requires ``grid_shape``; each offset must be either a pure-x step
        (|off| < nx) or a pure-y step (off = k * nx).
        """
        if self.grid_shape is None:
            raise ValueError("grid_offsets() needs grid_shape=(ny, nx)")
        _, nx = self.grid_shape
        out = []
        for off in self.offsets:
            if off % nx == 0:
                out.append((off // nx, 0))
            elif abs(off) < nx:
                out.append((0, off))
            else:
                raise ValueError(
                    f"offset {off} is neither a pure-x (|off|<{nx}) nor a "
                    f"pure-y (off % {nx} == 0) lattice step")
        return tuple(out)

    def halo_spec(self) -> HaloSpec:
        """W/E strips of the band reach; N/S/W/E when ``grid_shape`` set."""
        if self.grid_shape is not None:
            d = self.grid_offsets()
            hy = max((abs(dy) for dy, _ in d), default=0)
            hx = max((abs(dx) for _, dx in d), default=0)
            return HaloSpec(ndim=2, neighbors=("N", "S", "W", "E"),
                            widths=(hy, hy, hx, hx))
        h = self.halo
        return HaloSpec(ndim=1, neighbors=("W", "E"), widths=(h, h))

    def column_checksum(self) -> torch.Tensor:
        """ABFT column checksum ``c = A^T 1`` (kernels/checksum.py)."""
        from repro_torch.kernels.checksum import dia_column_checksum
        return dia_column_checksum(self.offsets, self.bands)

    def words_per_iter(self) -> float:
        """Fused-iteration HBM words/row: 10 vectors + one band sweep."""
        return 10.0 + float(len(self.offsets))

    def fingerprint(self) -> str:
        """sha1 over (offsets, bands): equal to the reference's key."""
        return _sha1_hex16(repr(tuple(self.offsets)).encode(),
                           tensor_bytes(self.bands))

    def structure_key(self) -> Tuple:
        """Compile-compatibility key (offsets + size, not coefficients)."""
        return ("dia",) + tuple(self.offsets)

    def inf_norm(self) -> float:
        """Host ``||A||_inf`` = max absolute row sum."""
        bands = self.bands.detach().to("cpu", torch.float64).numpy()
        return float(np.abs(bands).sum(axis=0).max())


SparseOperator.register(DiaMatrix)


def tridiagonal_laplacian(n: int, dtype=torch.float64,
                          device="cuda") -> DiaMatrix:
    """The ex23 operator: tridiag(-1, 2, -1)."""
    main = torch.full((n,), 2.0, dtype=dtype, device=device)
    lo = torch.full((n,), -1.0, dtype=dtype, device=device)  # offset -1
    hi = torch.full((n,), -1.0, dtype=dtype, device=device)  # offset +1
    lo[0] = 0.0
    hi[n - 1] = 0.0
    return DiaMatrix(offsets=(-1, 0, 1), bands=torch.stack([lo, main, hi]))


def laplacian_2d(nx: int, ny: int, dtype=torch.float64,
                 device="cuda") -> DiaMatrix:
    """5-point 2-D Laplacian on an nx x ny grid (row-major), as DIA."""
    n = nx * ny
    i = torch.arange(n, device=device)
    one = torch.full((n,), -1.0, dtype=dtype, device=device)
    zero = torch.zeros((n,), dtype=dtype, device=device)
    main = torch.full((n,), 4.0, dtype=dtype, device=device)
    west = torch.where(i % nx != 0, one, zero)
    east = torch.where(i % nx != nx - 1, one, zero)
    north = torch.where(i >= nx, one, zero)
    south = torch.where(i < n - nx, one, zero)
    bands = torch.stack([north, west, main, east, south])
    return DiaMatrix(offsets=(-nx, -1, 0, 1, nx), bands=bands,
                     grid_shape=(ny, nx))


def convection_diffusion(n: int, c: float = 0.4, shift: float = 0.2,
                         dtype=torch.float64, device="cuda") -> DiaMatrix:
    """1-D convection-diffusion operator: tridiag(-(1+c), 2+shift, -(1-c)).

    NONSYMMETRIC for ``c != 0``; ``shift > 0`` keeps it strictly
    diagonally dominant.
    """
    main = torch.full((n,), 2.0 + shift, dtype=dtype, device=device)
    lo = torch.full((n,), -(1.0 + c), dtype=dtype, device=device)
    hi = torch.full((n,), -(1.0 - c), dtype=dtype, device=device)
    lo[0] = 0.0
    hi[n - 1] = 0.0
    return DiaMatrix(offsets=(-1, 0, 1), bands=torch.stack([lo, main, hi]))


@dataclasses.dataclass(frozen=True)
class MatFreeOperator:
    """Matrix-free operator (e.g. Hessian-vector products)."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    n: int

    def matvec(self, x):
        return self.fn(x)


# --- preconditioners --------------------------------------------------------

def jacobi_preconditioner(A: DiaMatrix) -> Callable[[torch.Tensor], torch.Tensor]:
    """Diagonal (Jacobi) preconditioner: r -> diag(A)^-1 r."""
    inv_d = 1.0 / A.diagonal()
    return lambda r: inv_d * r


def identity_preconditioner(_A=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """No-op preconditioner (the M=None convention, as a callable)."""
    return lambda r: r
