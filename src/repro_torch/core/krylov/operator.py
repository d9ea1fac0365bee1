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
=================  ========================================================

``DiaMatrix`` (core/krylov/operators.py) is the implementation this
package ships; the blocked-ELL format comes with its kernels.
``as_operator`` keeps legacy ``(offsets, bands)`` call sites working with a
one-time ``DeprecationWarning``.
"""
from __future__ import annotations

import abc
import dataclasses
import hashlib
import warnings
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Neighbor set + strip widths one halo exchange must cover.

    ``neighbors`` names the logical directions ("W"/"E" for a 1-D chain
    decomposition, "N"/"S"/"W"/"E" for a 2-D process grid); ``widths``
    gives the matching strip width per neighbor, in lattice sites along
    the exchanged axis.
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

    Concrete formats register themselves as virtual subclasses, so
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
