"""Continuous batcher: k RHS slots advancing through ONE cached batch step.

The batcher holds a (k, n) PIPECG state (the engine-driven batch state of
``core/krylov/cg.py::_pipecg_engine``) with the per-column tol-freeze
machinery generalized so every column also carries its OWN ``first`` flag
(columns are admitted mid-flight, so "is this my first iteration" is per
column, not per batch).  Columns are independent: every engine op is
row-wise (elementwise updates, ``dim=-1`` reductions, per-row SpMV), and
on the card the fused sweep (kernels/pipecg_spmv_fused.py) keeps each
column's partial sums apart and finishes them in a fixed order (ROADMAP
H2), so admitting a request into a free column, retiring a converged one
or poisoning one with NaN cannot perturb the in-flight columns'
recurrences: bit for bit, which tests/test_torch_serve.py pins on the CPU
and tests/test_torch_cuda.py on the card.

On the fused engine with a DIA operator each iteration is ONE launch of
the sweep kernel over all k columns; each ``init`` (the batch's zero
state, and every admission) runs two SpMV launches.  Free and converged
columns still ride the sweep and are frozen by ``torch.where``, as the
reference's ``frz`` freezes them.

Built callables are cached at module scope keyed on the STATIC
configuration (engine, offsets, n, k, dtype, M, ip, step_block); the
operator is a runtime operand, so a second batcher over any same-family
operator reuses the first one's entry (warm serve path).  Each entry
counts its builds the way the reference counts jit traces: one per
operand shape a callable first meets (``init`` meets (k, n) and (1, n)).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.krylov.cg import _pipecg_scalars
from repro_torch.core.krylov.engine import Engine, get_engine
from repro_torch.core.krylov.operators import DiaMatrix
from repro_torch.serve.request import SolveRequest, dtype_name

_STEP_CACHE: Dict[Tuple, "_Compiled"] = {}


@dataclasses.dataclass
class _Compiled:
    """Built callables + build counters for one static batch config."""

    step: Callable
    init: Callable
    admit: Callable
    mark_done: Callable
    poison: Callable
    corrupt: Callable
    trace_counts: Dict[str, int]
    engine: Engine


def clear_compile_cache() -> None:
    """Drop every cached entry (tests)."""
    _STEP_CACHE.clear()


def _counted(name: str, fn: Callable, counts: Dict[str, int]) -> Callable:
    """``fn`` counting one build per distinct shape of its tensor operands."""
    seen = set()

    def run(*args):
        sig = tuple(tuple(a.shape) for a in args
                    if isinstance(a, torch.Tensor))
        if sig not in seen:
            seen.add(sig)
            counts[name] += 1
        return fn(*args)

    return run


def _build(engine: str, offsets: Tuple[int, ...], n: int, k: int,
           M, ip: str, step_block: int) -> _Compiled:
    eng = get_engine(engine)
    counts = {"step": 0, "init": 0, "admit": 0}

    def step_fn(ops, state, tol2):
        st = state
        for _ in range(step_block):
            alpha, beta = _pipecg_scalars(st, st["first"])
            vecs, gamma_new, delta_new, rr, _aux = eng.pipecg_iter(
                ops, ip, st["vecs"], alpha, beta)
            done = st["done"] | (rr <= tol2)
            mask = st["done"]

            def frz(nv, ov):  # freeze converged/free columns
                m = mask.reshape(mask.shape + (1,) * (nv.dim() - mask.dim()))
                return torch.where(m, ov, nv)

            st = dict(vecs={key: frz(v, st["vecs"][key])
                            for key, v in vecs.items()},
                      gamma=frz(gamma_new, st["gamma"]),
                      delta=frz(delta_new, st["delta"]),
                      gamma_prev=frz(st["gamma"], st["gamma_prev"]),
                      alpha_prev=frz(alpha, st["alpha_prev"]),
                      # a stepped column is past its first iteration;
                      # frozen columns keep their flag for re-admission
                      first=st["first"] & mask,
                      done=done,
                      iters=st["iters"] + (~done).to(torch.int32))
        r = st["vecs"]["r"]
        rr = torch.sum(r * r, dim=-1)
        # per-column ABFT state-deviation partials: the server combines
        # them with its host-side 1^T b to form delta = 1^T(b - A x - r)
        # (exact via c = A^T 1, the engine's prepared column sums: no
        # SpMV), plus the |.|-sums that scale its trip threshold
        cx = ops.csum * st["vecs"]["x"]
        det = torch.stack([torch.sum(cx, dim=-1), torch.sum(r, dim=-1),
                           torch.sum(torch.abs(cx), dim=-1),
                           torch.sum(torch.abs(r), dim=-1)], dim=-1)
        return st, (st["done"], st["iters"], rr, det)

    def init_fn(A, B):
        return eng.pipecg_init(A, B, None, M, ip)

    # the slot writes below are in place: each state tensor is its own
    # buffer (ContinuousBatcher.__init__ clones the zero state, and every
    # step returns fresh tensors)
    def admit_fn(state, slot, col_vecs, gamma0, delta0):
        for key, leaf in state["vecs"].items():
            leaf[slot] = col_vecs[key][0]
        state["gamma"][slot] = gamma0[0]
        state["delta"][slot] = delta0[0]
        state["gamma_prev"][slot] = 1.0
        state["alpha_prev"][slot] = 1.0
        state["first"][slot] = True
        state["done"][slot] = False
        state["iters"][slot] = 0
        return state

    def mark_done_fn(state, slot):
        state["done"][slot] = True
        return state

    def poison_fn(state, slot):
        for leaf in state["vecs"].values():
            leaf[slot] = float("nan")
        return state

    def corrupt_fn(state, slot, magnitude):
        # the carried SOLUTION is the silent target: the recurrence
        # (r, u, p, ...) never sees it, so the column still "converges";
        # only the server's host-side true-residual check catches it
        state["vecs"]["x"][slot] += magnitude
        return state

    return _Compiled(step=_counted("step", step_fn, counts),
                     init=_counted("init", init_fn, counts),
                     admit=_counted("admit", admit_fn, counts),
                     mark_done=mark_done_fn, poison=poison_fn,
                     corrupt=corrupt_fn, trace_counts=counts, engine=eng)


def get_compiled(engine: str, offsets: Tuple[int, ...], n: int, k: int,
                 dtype, M, ip: str, step_block: int) -> _Compiled:
    """Cached callables for one static batch configuration."""
    key = (engine, tuple(int(o) for o in offsets), int(n), int(k),
           dtype_name(torch.empty(0, dtype=dtype)), M, ip, int(step_block))
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = _build(engine, key[1], int(n), int(k), M, ip,
                                  int(step_block))
    return _STEP_CACHE[key]


def host64(v) -> np.ndarray:
    """float64 host copy of a numpy array or a tensor on any device."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64, copy=True).numpy()
    return np.asarray(v, np.float64)


class ContinuousBatcher:
    """k-slot multi-RHS PIPECG batch with mid-flight admit/retire.

    One instance is bound to one operator (a runtime operand of the shared
    callables; the state lives on its device).  The server drives it:
    ``admit`` fills a free column from a request, ``step`` advances every
    column by ``step_block`` iterations (free/converged columns stay
    frozen), and the returned (done, iters, rr) triple tells the caller
    which columns to retire via ``take``/``release``.
    """

    def __init__(self, A: DiaMatrix, k_slots: int, *, engine: str = "fused",
                 M: Optional[str] = None, ip: str = "id",
                 step_block: int = 8):
        self.A = A
        self.k = int(k_slots)
        self.engine = engine
        self.M = M
        self.ip = ip
        self.step_block = int(step_block)
        self.dtype = A.dtype
        self.device = A.device
        self.compiled = get_compiled(engine, tuple(A.offsets), A.n, self.k,
                                     self.dtype, M, ip, self.step_block)
        # the solve's loop invariants, once per batcher: diag^-1 and the
        # column sums c = A^T 1 that the ABFT deviation reads every block
        self.ops = self.compiled.engine.prepare(A, M, self.dtype)
        zero = torch.zeros((self.k, A.n), dtype=self.dtype,
                           device=self.device)
        vecs, _, _ = self.compiled.init(A, zero)

        def ones(dtype=self.dtype):
            return torch.ones((self.k,), dtype=dtype, device=self.device)

        self.state = dict(vecs={key: v.clone() for key, v in vecs.items()},
                          gamma=ones(), delta=ones(), gamma_prev=ones(),
                          alpha_prev=ones(), first=ones(torch.bool),
                          done=ones(torch.bool),
                          iters=torch.zeros((self.k,), dtype=torch.int32,
                                            device=self.device))
        self.tol2 = np.zeros((self.k,), np.float64)
        self._tol2_dev: Optional[torch.Tensor] = None
        # host-side 1^T b and sum |b| per slot (the b-leg of the ABFT
        # state deviation; the device returns the x/r legs from step()),
        # and each slot's float64 host b for the server's exit check
        self.bsum = np.zeros((self.k,), np.float64)
        self.babs = np.zeros((self.k,), np.float64)
        self.b_host: List[Optional[np.ndarray]] = [None] * self.k
        self._bands_host: Optional[np.ndarray] = None
        self.slots: List[Optional[SolveRequest]] = [None] * self.k
        self.blocks = 0
        self.deviation = np.zeros((self.k,), np.float64)
        self.dev_scale = np.zeros((self.k,), np.float64)

    @property
    def trace_counts(self) -> Dict[str, int]:
        """Build counters of the shared cache entry."""
        return self.compiled.trace_counts

    @property
    def bands_host(self) -> np.ndarray:
        """Host copy of the operator bands (taken once, for exit checks)."""
        if self._bands_host is None:
            self._bands_host = self.A.bands.detach().to(
                "cpu", copy=True).numpy()
        return self._bands_host

    def free_slots(self) -> List[int]:
        """Indices of unoccupied columns."""
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def active(self) -> int:
        """Number of occupied columns."""
        return self.k - len(self.free_slots())

    def admit(self, slot: int, req: SolveRequest) -> None:
        """Initialize column ``slot`` from ``req`` (never touches others)."""
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        b = torch.as_tensor(req.b, dtype=self.dtype,
                            device=self.device)[None, :]
        col_vecs, gamma0, delta0 = self.compiled.init(self.A, b)
        self.state = self.compiled.admit(self.state, slot, col_vecs,
                                         gamma0, delta0)
        b64 = host64(req.b)
        self.tol2[slot] = req.tol ** 2 * float(np.dot(b64, b64))
        self._tol2_dev = None
        self.bsum[slot] = float(b64.sum())
        self.babs[slot] = float(np.abs(b64).sum())
        self.b_host[slot] = b64
        self.slots[slot] = req

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance every column by ``step_block`` iterations.

        Returns host copies of (done, iters, rr): the per-column freeze
        flags, per-column iteration counts since admission, and squared
        residual norms.  The per-column ABFT deviations of the same block
        are cached on ``self.deviation`` / ``self.dev_scale`` (combined
        with the host-side b-sums stored at admit).  One device-to-host
        copy carries all of it.
        """
        if self._tol2_dev is None:
            self._tol2_dev = torch.tensor(self.tol2, device=self.device)
        self.state, (done, iters, rr, det) = self.compiled.step(
            self.ops, self.state, self._tol2_dev)
        self.blocks += 1
        f64 = torch.float64
        host = torch.cat([done.to(f64)[:, None], iters.to(f64)[:, None],
                          rr.to(f64)[:, None], det.to(f64)], dim=1)
        host = host.to("cpu", copy=True).numpy()
        # delta = 1^T b - c^T x - 1^T r == 1^T (b - A x - r); rounding-level
        # for any state the recurrence produced, O(corruption) otherwise
        self.deviation = self.bsum - host[:, 3] - host[:, 4]
        self.dev_scale = self.babs + host[:, 5] + host[:, 6]
        rr_np = host[:, 2].astype(dtype_name(rr))
        return host[:, 0] != 0.0, host[:, 1].astype(np.int32), rr_np

    def take(self, slot: int) -> np.ndarray:
        """Host copy of column ``slot``'s current solution iterate."""
        return self.state["vecs"]["x"][slot].detach().to(
            "cpu", copy=True).numpy()

    def release(self, slot: int) -> None:
        """Retire column ``slot``: freeze it and free the slot."""
        self.state = self.compiled.mark_done(self.state, slot)
        self.tol2[slot] = 0.0
        self._tol2_dev = None
        self.b_host[slot] = None
        self.slots[slot] = None

    def poison(self, slot: int) -> None:
        """Chaos hook: corrupt column ``slot``'s vectors with NaNs."""
        self.state = self.compiled.poison(self.state, slot)

    def corrupt(self, slot: int, magnitude: float) -> None:
        """Chaos hook: silently derail column ``slot``'s solution."""
        self.state = self.compiled.corrupt(self.state, slot,
                                           float(magnitude))
