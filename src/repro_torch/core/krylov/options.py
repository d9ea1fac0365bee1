"""Typed solver configuration: one ``options=`` object, not loose kwargs.

:class:`PrecisionPolicy` names the dtype roles of a pipelined solve: the
STORAGE dtype of the carried basis vectors and the resident operator
(bf16 -> ``torch.bfloat16``, fp8 -> ``torch.float8_e4m3fn``), the ACCUM
dtype of every reduction and scalar recurrence (always full working
precision), and the WIRE encoding of halo strips (distributed solves).

:class:`SolverOptions` bundles the solver knobs; legacy loose kwargs keep
working through :meth:`SolverOptions.from_kwargs`, which maps ``l=`` to
``depth``, raises on unknown keys with the list of valid fields, and warns
``DeprecationWarning`` exactly once per process.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch


class _Unset:
    """Sentinel distinguishing 'kwarg not passed' from an explicit None."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "<unset>"


#: Default value for legacy solver kwargs: lets the resolver tell "caller
#: typed engine=None" apart from "caller never mentioned engine".
UNSET = _Unset()

# fp8 storage is gated on the torch build shipping the dtype
FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

_STORAGE = ("fp32", "bf16", "fp8")
_WIRE = ("fp32", "int8")
# machine epsilons of the storage formats (unit roundoff, 2^-(mantissa+1))
_STORAGE_EPS = {"fp32": 2.0 ** -24, "bf16": 2.0 ** -8, "fp8": 2.0 ** -4}
# fp32-equivalent words per stored element (bytes / 4)
_STORAGE_WORDS = {"fp32": 1.0, "bf16": 0.5, "fp8": 0.25}
_WIRE_WORDS = {"fp32": 1.0, "int8": 0.25}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Which dtype each array role of a pipelined solve uses.

    ``storage`` covers the carried basis vectors (r, u, p) and the
    resident operator (bands, diag^-1, the ABFT column sums); the solution
    ``x`` and every reduction stay at ``accum``.  ``wire`` and
    ``wire_gram`` cover the halo strips and the carried Gram payload of
    distributed solves; ``error_feedback`` keeps a sender-side residual on
    the int8 halo wire.
    """

    storage: str = "fp32"
    accum: str = "fp32"
    wire: str = "fp32"
    error_feedback: bool = True
    wire_gram: str = "fp32"

    def __post_init__(self) -> None:
        """Validate the policy against the supported dtype roles."""
        if self.storage not in _STORAGE:
            raise ValueError(f"storage={self.storage!r} not in {_STORAGE}")
        if self.accum != "fp32":
            raise ValueError(
                "accum must stay 'fp32' (full working precision): Gram "
                "partials, scalar recurrences and the carried psum row are "
                "never down-cast")
        if self.wire not in _WIRE:
            raise ValueError(f"wire={self.wire!r} not in {_WIRE}")
        if self.wire_gram not in _WIRE:
            raise ValueError(
                f"wire_gram={self.wire_gram!r} not in {_WIRE}")
        if self.storage == "fp8" and FP8_DTYPE is None:
            raise ValueError(
                "storage='fp8' needs a torch build with float8_e4m3fn")

    @property
    def storage_dtype(self):
        """torch dtype of the carried vectors; None = keep the solve dtype."""
        if self.storage == "bf16":
            return torch.bfloat16
        if self.storage == "fp8":
            return FP8_DTYPE
        return None

    @property
    def storage_eps(self) -> float:
        """Unit roundoff of the storage format (the Cools-bound input)."""
        return _STORAGE_EPS[self.storage]

    @property
    def storage_words(self) -> float:
        """fp32-equivalent words per stored element (bytes / 4)."""
        return _STORAGE_WORDS[self.storage]

    @property
    def wire_words(self) -> float:
        """fp32-equivalent words per element on the wire (bytes / 4)."""
        return _WIRE_WORDS[self.wire]

    @property
    def is_default(self) -> bool:
        """True when the policy changes nothing (pure fp32 everywhere)."""
        return (self.storage == "fp32" and self.wire == "fp32"
                and self.wire_gram == "fp32")

    @classmethod
    def from_name(cls, name: str) -> "PrecisionPolicy":
        """Named presets (the reference's campaign precision stage)."""
        presets = {
            "fp32": cls(),
            "bf16": cls(storage="bf16"),
            "bf16_int8wire": cls(storage="bf16", wire="int8",
                                 error_feedback=True),
            "bf16_int8wire_noef": cls(storage="bf16", wire="int8",
                                      error_feedback=False),
            # full-wire demonstrator: also quantizes the carried Gram
            # payload — known-unsafe
            "bf16_int8allwire": cls(storage="bf16", wire="int8",
                                    error_feedback=True,
                                    wire_gram="int8"),
        }
        if FP8_DTYPE is not None:
            presets["fp8"] = cls(storage="fp8")
        if name not in presets:
            raise ValueError(f"unknown precision preset {name!r}; "
                             f"valid: {sorted(presets)}")
        return presets[name]


def as_policy(precision) -> PrecisionPolicy:
    """Coerce ``None`` / preset name / policy object into a policy."""
    if precision is None:
        return PrecisionPolicy()
    if isinstance(precision, str):
        return PrecisionPolicy.from_name(precision)
    if not isinstance(precision, PrecisionPolicy):
        raise TypeError(
            f"precision= must be None, a preset name, or a "
            f"PrecisionPolicy, got {type(precision).__name__}")
    return precision


# legacy kwarg spellings that trigger the one-shot DeprecationWarning
_DEPRECATED_KEYS = frozenset({"engine", "rr", "rr_tau", "l", "noise", "M"})
_warned_deprecated = False


def reset_deprecation_warning() -> None:
    """Re-arm the once-per-process legacy-kwarg warning (tests only)."""
    global _warned_deprecated
    _warned_deprecated = False


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """The typed bag of solver knobs shared by every Krylov entry point."""

    maxiter: int = 100
    tol: float = 0.0
    M: Any = None
    engine: Optional[str] = None
    depth: int = 1
    rr: int = 0
    rr_tau: float = 0.0
    precision: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy)
    noise: Any = None

    def __post_init__(self) -> None:
        """Coerce a named precision preset into its PrecisionPolicy."""
        if isinstance(self.precision, str):
            object.__setattr__(self, "precision",
                               PrecisionPolicy.from_name(self.precision))

    @classmethod
    def from_kwargs(cls, **kw: Any) -> "SolverOptions":
        """Build options from the legacy kwarg spellings.

        Maps ``l=`` to ``depth``, rejects unknown keys with the list of
        valid fields, and emits ``DeprecationWarning`` once per process
        when any deprecated spelling (engine/rr/rr_tau/l/noise/M) is used.
        """
        global _warned_deprecated
        deprecated = sorted(_DEPRECATED_KEYS & set(kw))
        if "l" in kw:
            if "depth" in kw:
                raise TypeError("pass either l= (legacy) or depth=, not both")
            kw["depth"] = kw.pop("l")
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kw) - valid)
        if unknown:
            raise TypeError(
                f"unknown solver option(s) {unknown}; valid fields: "
                f"{sorted(valid)} (plus the legacy alias 'l' for depth)")
        if deprecated and not _warned_deprecated:
            _warned_deprecated = True
            warnings.warn(
                f"passing {deprecated} as loose solver kwargs is deprecated; "
                "use options=SolverOptions(...) (core/krylov/options.py)",
                DeprecationWarning, stacklevel=3)
        return cls(**kw)


def resolve_options(options: Optional[SolverOptions] = None,
                    **legacy: Any) -> SolverOptions:
    """Merge an ``options=`` object with per-call legacy kwargs.

    ``legacy`` values equal to :data:`UNSET` were not passed by the
    caller.  Passing BOTH an options object and an explicit legacy kwarg
    raises; with no options object the explicit legacy kwargs go through
    :meth:`SolverOptions.from_kwargs`.
    """
    passed = {k: v for k, v in legacy.items() if v is not UNSET}
    if options is not None:
        if passed:
            raise TypeError(
                f"cannot mix options=SolverOptions(...) with legacy "
                f"kwargs {sorted(passed)}; fold them into the options "
                "object")
        if not isinstance(options, SolverOptions):
            raise TypeError(f"options= must be a SolverOptions, got "
                            f"{type(options).__name__}")
        return options
    return SolverOptions.from_kwargs(**passed)


# what to tell a caller who set a field on a solver that cannot honor it
_UNSUPPORTED_HINTS = {
    "engine": "this entry point has no engine-backed path",
    "depth": "pipeline depth belongs to pipecg_l / pgmres / pgmres_l "
             "(and distributed_solve(pipecg_l, ...))",
    "rr": "periodic residual replacement belongs to pipecg_l / "
          "pipebicgstab",
    "rr_tau": "adaptive residual replacement belongs to pipecg / "
              "pipecg_l / pipebicgstab engine paths",
    "noise": "reduction-noise injection belongs to distributed_solve",
    "precision": "mixed-precision policies apply to the engine-backed "
                 "pipecg path and to distributed_solve "
                 "(engine='sharded_fused')",
}


def check_supported(opts: SolverOptions, solver: str,
                    supported=()) -> None:
    """Raise when ``opts`` sets a field ``solver`` cannot honor.

    ``supported`` lists the optional-feature fields the solver consumes
    (``maxiter`` / ``tol`` / ``M`` are universal and never checked).
    """

    def bad(name: str) -> None:
        raise ValueError(f"{solver}() does not honor options.{name}: "
                         f"{_UNSUPPORTED_HINTS[name]}")

    if "engine" not in supported and opts.engine is not None:
        bad("engine")
    if "depth" not in supported and opts.depth != 1:
        bad("depth")
    if "rr" not in supported and opts.rr:
        bad("rr")
    if "rr_tau" not in supported and opts.rr_tau:
        bad("rr_tau")
    if "noise" not in supported and opts.noise is not None:
        bad("noise")
    if "precision" not in supported and not opts.precision.is_default:
        bad("precision")
