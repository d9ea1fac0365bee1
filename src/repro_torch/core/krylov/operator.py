"""Typed ``SparseOperator`` protocol: one operator object through every layer.

=================  ========================================================
protocol member    consumer
=================  ========================================================
``matvec``         solvers / engines (device SpMV)
``diagonal``       Jacobi preconditioner resolution (engine.py)
``halo_spec``      distributed halo exchange: neighbor set + strip widths
``column_checksum``  ABFT ``c = A^T 1`` (abft.py / kernels/checksum.py)
``words_per_iter``   HBM-traffic accounting of one fused iteration
``fingerprint``    content key (sha1 over structure + coefficients)
``structure_key``  compile-compatibility grouping (shapes, not values)
``inf_norm``       ``||A||_inf`` on the host
``host_matvec``    numpy ground-truth residuals (hostops.py)
=================  ========================================================

Two implementations ship: ``DiaMatrix`` (core/krylov/operators.py, banded
stencils) and ``BsrMatrix`` (below: blocked-row sparse in a padded uniform
row-degree ELL layout, the format of kernels/spmv_bsr.py).
``as_operator`` keeps legacy ``(offsets, bands)`` call sites working with a
one-time ``DeprecationWarning``.
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
import warnings
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Neighbor set + strip widths one halo exchange must cover.

    ``neighbors`` names the logical directions ("W"/"E" for a 1-D chain
    decomposition, "N"/"S"/"W"/"E" for a 2-D process grid); ``widths``
    gives the matching strip width per neighbor, in lattice sites along
    the exchanged axis (block rows for BSR).
    """

    ndim: int
    neighbors: Tuple[str, ...]
    widths: Tuple[int, ...]

    def __post_init__(self):
        if len(self.neighbors) != len(self.widths):
            raise ValueError("neighbors and widths must align")
        if len(self.neighbors) != 2 * self.ndim:
            raise ValueError(
                f"a {self.ndim}-D decomposition has {2 * self.ndim} "
                f"neighbors, got {self.neighbors}")

    @property
    def messages_per_exchange(self) -> int:
        """Messages per exchanged vector for an interior process."""
        return len(self.neighbors)

    def width(self, name: str) -> int:
        """Strip width toward neighbor ``name`` (e.g. ``"W"``)."""
        return self.widths[self.neighbors.index(name)]


class SparseOperator(abc.ABC):
    """Abstract base for the operator protocol (see module docstring).

    Concrete formats (``DiaMatrix``, ``BsrMatrix``) register themselves as
    virtual subclasses, so
    ``isinstance(A, SparseOperator)`` is the single dispatch test wherever
    an operator crosses a layer boundary.
    """

    @property
    @abc.abstractmethod
    def n(self) -> int:
        """Global problem size (rows)."""

    @abc.abstractmethod
    def matvec(self, x):
        """Device SpMV ``y = A x`` (plain torch)."""

    @abc.abstractmethod
    def diagonal(self):
        """``diag(A)`` as an (n,) vector (Jacobi preconditioning)."""

    @abc.abstractmethod
    def halo_spec(self) -> HaloSpec:
        """Neighbor set + strip widths for one distributed halo exchange."""

    @abc.abstractmethod
    def column_checksum(self):
        """ABFT column checksum ``c = A^T 1`` as an (n,) vector."""

    @abc.abstractmethod
    def words_per_iter(self) -> float:
        """Modeled HBM words per row for one fused PIPECG iteration."""

    @abc.abstractmethod
    def fingerprint(self) -> str:
        """Content hash over structure + coefficients."""


def tensor_bytes(t: torch.Tensor) -> bytes:
    """Raw little-endian bytes of ``t`` in row-major order, any dtype."""
    return t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()


def _sha1_hex16(*chunks: bytes) -> str:
    h = hashlib.sha1()
    for c in chunks:
        h.update(c)
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# BSR (blocked-row sparse, padded uniform row-degree ELL layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Blocked-row sparse matrix in a padded uniform row-degree ELL layout.

    ``indices[i, d]`` (int32) is the block column of the d-th stored block
    of block row ``i`` and ``blocks[i, d]`` its dense (bs, bs)
    coefficients; every block row stores exactly ``max_deg`` entries,
    padded with SELF-POINTING all-zero blocks (``indices[i, d] = i``), so
    a gather never leaves the matrix and a pad folds into the diagonal
    block's band.  Construction checks the shapes and that every index
    names a block row (one host read of the index range).
    """

    indices: torch.Tensor  # (n_block_rows, max_deg) int32
    blocks: torch.Tensor   # (n_block_rows, max_deg, bs, bs)

    def __post_init__(self):
        ind, blk = self.indices, self.blocks
        if ind.dtype != torch.int32 or ind.dim() != 2:
            raise ValueError(f"indices must be (nbr, deg) int32, got "
                             f"{tuple(ind.shape)} {ind.dtype}")
        if blk.dim() != 4 or tuple(blk.shape[:2]) != tuple(ind.shape) \
                or blk.shape[2] != blk.shape[3]:
            raise ValueError(f"blocks {tuple(blk.shape)} do not fit indices "
                             f"{tuple(ind.shape)} as (nbr, deg, bs, bs)")
        if ind.device != blk.device:
            raise ValueError(f"indices on {ind.device}, blocks on "
                             f"{blk.device}")
        if ind.numel() and not (0 <= int(ind.min())
                                and int(ind.max()) < ind.shape[0]):
            raise ValueError("a block-column index lies outside "
                             f"[0, {ind.shape[0]})")

    @property
    def n(self) -> int:
        """Global row count ``n_block_rows * bs``."""
        return self.blocks.shape[0] * self.blocks.shape[-1]

    @property
    def n_block_rows(self) -> int:
        """Number of block rows."""
        return self.blocks.shape[0]

    @property
    def bs(self) -> int:
        """Dense block edge length."""
        return self.blocks.shape[-1]

    @property
    def max_deg(self) -> int:
        """Stored blocks per block row (pad entries included)."""
        return self.blocks.shape[1]

    @property
    def dtype(self):
        """Coefficient dtype."""
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        """Device the blocks live on."""
        return self.blocks.device

    @property
    def format(self) -> str:
        """Format tag ("bsr") for table-driven dispatch."""
        return "bsr"

    def _offsets_np(self) -> np.ndarray:
        """Block-column offsets ``indices[i, d] - i`` on the host."""
        ind = self.indices.detach().cpu().numpy().astype(np.int64)
        return ind - np.arange(self.n_block_rows)[:, None]

    @property
    def halo(self) -> int:
        """Max |block column - block row| reach, in SCALAR rows."""
        return self.block_halo * self.bs

    @property
    def block_halo(self) -> int:
        """Max |block column - block row| reach, in BLOCK rows."""
        return int(np.abs(self._offsets_np()).max())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` in plain torch: one gather of x blocks, the block
        terms added in the SpMV kernel's order (kernels/spmv_bsr.py)."""
        from repro_torch.kernels.spmv_bsr import spmv_bsr_plain
        return spmv_bsr_plain(self.indices, self.blocks, x)

    def diagonal(self) -> torch.Tensor:
        """``diag(A)``: the diagonals of the self-column blocks."""
        own = self.indices == torch.arange(
            self.n_block_rows, device=self.device,
            dtype=torch.int32)[:, None]
        d = torch.diagonal(self.blocks, dim1=-2, dim2=-1)  # (nbr, deg, bs)
        return torch.where(own[..., None], d, torch.zeros_like(d)) \
            .sum(dim=1).reshape(self.n)

    def to_dense(self) -> torch.Tensor:
        """Dense (n, n) rendering (tests / small problems only)."""
        nbr, bs = self.n_block_rows, self.bs
        A = torch.zeros((nbr, nbr, bs, bs), dtype=self.dtype,
                        device=self.device)
        rows = torch.arange(nbr, device=self.device)
        for d in range(self.max_deg):
            A.index_put_((rows, self.indices[:, d].long()),
                         self.blocks[:, d], accumulate=True)
        return A.permute(0, 2, 1, 3).reshape(self.n, self.n)

    def halo_spec(self) -> HaloSpec:
        """1-D block-row chain decomposition: W/E strips of the block reach."""
        h = self.block_halo
        return HaloSpec(ndim=1, neighbors=("W", "E"), widths=(h, h))

    def column_checksum(self) -> torch.Tensor:
        """``c = A^T 1`` (kernels/checksum.py, a fixed-order segment sum)."""
        from repro_torch.kernels.checksum import bsr_column_checksum
        return bsr_column_checksum(self.indices, self.blocks)

    def words_per_iter(self) -> float:
        """Fused-iteration HBM words/row: 10 vectors + blocks + int32 ELL."""
        return 10.0 + float(self.max_deg) * self.bs \
            + float(self.max_deg) / self.bs

    def fingerprint(self) -> str:
        """sha1 over (format, shape, indices, blocks): the reference's key."""
        return _sha1_hex16(b"bsr", repr(tuple(self.indices.shape)).encode(),
                           tensor_bytes(self.indices),
                           tensor_bytes(self.blocks))

    def structure_key(self) -> Tuple:
        """Compile-compatibility key (shapes only, not coefficients)."""
        return ("bsr", self.n_block_rows, self.max_deg, self.bs)

    def inf_norm(self) -> float:
        """Host ``||A||_inf`` = max absolute row sum."""
        blk = self.blocks.detach().to("cpu", torch.float64).numpy()
        return float(np.abs(blk).sum(axis=(1, 3)).max())

    def host_matvec(self, x: np.ndarray) -> np.ndarray:
        """Numpy ground-truth ``y = A x`` (host residual checks)."""
        blk = self.blocks.detach().cpu().numpy()
        ind = self.indices.detach().cpu().numpy()
        xb = np.reshape(x, x.shape[:-1] + (self.n_block_rows, self.bs))
        y = np.einsum("rdij,...rdj->...ri", blk, xb[..., ind, :])
        return np.reshape(y, x.shape)

    def block_bands(self) -> Tuple[Tuple[int, ...], torch.Tensor]:
        """Block-DIA rendering ``(boffs, bblocks)`` for the sharded body.

        ``boffs`` is the sorted tuple of distinct block-column offsets
        ``indices[i, d] - i`` and ``bblocks[m, i]`` the dense block that
        connects block row ``i`` to block column ``i + boffs[m]`` (zero
        where the row stores no such block).  Pads are zero blocks at
        offset 0 and fold in harmlessly.
        """
        offs = self._offsets_np()
        boffs = tuple(int(o) for o in np.unique(offs))
        offs_t = torch.from_numpy(offs).to(self.device)
        zero = torch.zeros_like(self.blocks)
        bblocks = torch.stack([
            torch.where((offs_t == off)[..., None, None], self.blocks,
                        zero).sum(dim=1) for off in boffs])
        return boffs, bblocks


SparseOperator.register(BsrMatrix)


def dia_to_bsr(A, bs: int = 4) -> BsrMatrix:
    """Convert a ``DiaMatrix`` to BSR with block size ``bs`` (lossless).

    The reference's conversion, vectorised on the host: every nonzero band
    entry ``A[i, i+off]`` lands in block ``(i // bs, (i+off) // bs)``;
    each block row lists its blocks by ascending block column and is
    padded to the largest degree (at least 1) with self-pointing zero
    blocks.  ``indices`` and ``blocks`` equal the JAX package's byte for
    byte.  Requires ``A.n % bs == 0``.
    """
    n = A.n
    if n % bs:
        raise ValueError(f"n={n} not divisible by block size {bs}")
    nbr = n // bs
    bands = A.bands.detach().cpu().numpy()
    rows, cols, vals = [], [], []
    for k, off in enumerate(A.offsets):
        i = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        v = bands[k, i]
        keep = v != 0.0
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(v[keep])
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    # blocks sorted by (block row, block column), each entry's block id
    uniq, which = np.unique((rows // bs) * nbr + cols // bs,
                            return_inverse=True)
    ubr, ubc = uniq // nbr, uniq % nbr
    counts = np.bincount(ubr, minlength=nbr)
    deg = max(int(counts.max()) if counts.size else 1, 1)
    slot = np.arange(uniq.size) - (np.cumsum(counts) - counts)[ubr]
    indices = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, deg))
    indices[ubr, slot] = ubc
    blocks = np.zeros((nbr, deg, bs, bs), bands.dtype)
    # band order, as the reference accumulates a repeated offset
    np.add.at(blocks, (ubr[which], slot[which], rows % bs, cols % bs), vals)
    dev = A.bands.device
    return BsrMatrix(indices=torch.from_numpy(indices).to(dev),
                     blocks=torch.from_numpy(blocks).to(dev))


# one-time flag, module-global like options._warned_deprecated so the
# warning fires once per process, not once per call site
_warned_legacy_pair = False


def reset_operator_deprecation_warning() -> None:
    """Re-arm the one-time legacy-pair warning (test helper)."""
    global _warned_legacy_pair
    _warned_legacy_pair = False


def as_operator(A, bands=None):
    """Coerce ``A`` to a ``SparseOperator``, accepting the legacy DIA pair.

    ``as_operator(op)`` passes a protocol object through unchanged;
    ``as_operator(offsets, bands)`` or ``as_operator((offsets, bands))``
    wraps the pair in a ``DiaMatrix`` on the device of ``bands`` and emits
    a one-time ``DeprecationWarning``.  Matrix-free callables pass through.
    """
    global _warned_legacy_pair
    if bands is None and not (isinstance(A, tuple) and len(A) == 2):
        return A
    if bands is None:
        offsets, bands = A
    else:
        offsets = A
    if not _warned_legacy_pair:
        _warned_legacy_pair = True
        warnings.warn(
            "passing a raw (offsets, bands) DIA pair is deprecated; "
            "construct a DiaMatrix (core.krylov.operators) and pass the "
            "operator object", DeprecationWarning, stacklevel=2)
    from repro_torch.core.krylov.operators import DiaMatrix
    return DiaMatrix(offsets=tuple(int(o) for o in offsets),
                     bands=torch.as_tensor(bands))
