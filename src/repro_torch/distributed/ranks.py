"""Start P ranks of one process group: the counterpart of building a mesh.

``run(fn, world, *args)`` spawns ``world`` processes, joins them into one
``torch.distributed`` group through a ``FileStore`` in a fresh temporary
directory (no fixed port, so concurrent runs cannot collide), calls
``fn(rank, world, *args)`` on each and returns the results in rank order.
``fn`` must be importable by the children: a module-level function of an
installed module (``solve_cases`` below) or of the script that calls
``run`` from under ``if __name__ == "__main__"``.

Backend: NCCL when every rank has its own card, gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU.  The
choice follows the device count, never a retry after an error.  Gloo
ranks also map one shared-memory wire (distributed/shm.py), which
carries the whole group's sums and strips, and, when they share the
machine's one card, the card's IPC buffers (distributed/card_wire.py),
which carry the sharded models' gathers and sums.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import card_wire, shm

#: seconds a rank waits on a peer before its collective fails
TIMEOUT_S = 300


def backend_for(world: int, device) -> str:
    """'nccl' when each of ``world`` ranks gets its own card, else 'gloo'."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world \
            and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, tmp: str, args: tuple) -> None:
    kw = {}
    if torch.device(device).type == "cuda":
        card = rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", card)
    else:
        torch.set_num_threads(1)   # P ranks share the host's cores
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **kw)
    wire = os.path.join(tmp, "wire")
    if os.path.exists(wire):
        shm.attach(wire, rank, world)
    if card_wire.usable(backend, device):
        card_wire.attach(torch.device("cuda", torch.cuda.current_device()))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        card_wire.detach()
        shm.detach()
        dist.destroy_process_group()


class Spawned:
    """Ranks started by :func:`start`; :meth:`result` waits for them."""

    def __init__(self, context, tmp, world: int):
        self._context, self._tmp, self._world = context, tmp, world

    def result(self) -> List[Any]:
        """Each rank's return value, in rank order (a failing rank raises
        here)."""
        try:
            while not self._context.join():
                pass
            out = []
            for r in range(self._world):
                with open(os.path.join(self._tmp.name, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._tmp.cleanup()

    def cancel(self) -> None:
        """Stop the ranks (a caller that will not wait for them)."""
        for p in self._context.processes:
            if p.is_alive():
                p.terminate()
            p.join()
        self._tmp.cleanup()


def start(fn: Callable, world: int, *args, device="cuda") -> Spawned:
    """Start ``fn(rank, world, *args)`` on ``world`` spawned ranks and
    return at once; ``.result()`` waits for them (see :func:`run`)."""
    backend = backend_for(world, device)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()
    tmp = tempfile.TemporaryDirectory(prefix="repro_torch_ranks_")
    try:
        if backend == "gloo" and shm.usable():
            shm.create(os.path.join(tmp.name, "wire"), world)
        context = mp.spawn(_rank_main, args=(fn, world, backend, str(device),
                                             tmp.name, args),
                           nprocs=world, join=False)
    except BaseException:
        tmp.cleanup()
        raise
    return Spawned(context, tmp, world)


def run(fn: Callable, world: int, *args, device="cuda") -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks.

    ``device`` (the card unless the caller asks for ``"cpu"``) picks the backend (:func:`backend_for`) and, for CUDA, each
    rank's current card (rank modulo the card count); the CUDA kernels are
    built here first, so the ranks do not each compile them.  A failing
    rank raises here.
    """
    return start(fn, world, *args, device=device).result()


def _on_mesh(rank: int, world: int, fn: Callable, shape: Dict[str, int],
             *args) -> Any:
    from repro_torch.launch.mesh import Mesh
    return fn(rank, world, Mesh.live(shape), *args)


def run_mesh(fn: Callable, shape: Dict[str, int], *args, device="cuda"
             ) -> List[Any]:
    """Run ``fn(rank, world, mesh, *args)`` on as many spawned ranks as
    ``shape`` (axis name -> size, e.g. ``{"data": 2, "model": 2}``) holds,
    ``mesh`` the ``launch.mesh.Mesh`` of that shape built inside each
    rank (a body may build more meshes of the same ranks itself, with
    ``make_host_mesh``).  As :func:`run` otherwise."""
    world = 1
    for size in shape.values():
        world *= size
    return run(_on_mesh, world, fn, dict(shape), *args, device=device)


def _numpy(v):
    return None if v is None else v.detach().cpu().numpy()


def solve_cases(rank: int, world: int, cases: List[Dict[str, Any]],
                device: str = "cuda") -> List[Dict[str, Any]]:
    """Rank body: run ``distributed_solve`` once per case, report as numpy.

    A case is a dict with ``solver`` (a name in ``core.krylov``), ``A`` (a
    ``DiaMatrix`` or a ``BsrMatrix``) and ``b`` (a tensor), both global and
    moved to ``device`` here, ``kw`` (keyword arguments of
    ``distributed_solve``) and optionally ``noise``, the ``(dist, scale,
    seed)`` of a ``NoiseHook`` built on this rank, and ``grid``, a
    ``(py, px)`` process grid the group's ranks are laid on
    (``group=(None, grid)``).  Each outcome holds the result's
    fields, the kernel launches, the blocking all-reduces
    (``comm.all_reduce`` calls), the point-to-point bytes this rank sent
    by dtype (``wire_bytes``) and the wall seconds of the solve (ranks
    start together; the card is synchronised around it) and this rank's
    injected waits; a sharded solve adds its order check (split-phase, or
    ``depth_order_ok`` for ``pipecg_l`` with ``l > 1``), the reductions
    its recorder saw issued (``reductions``) and the mean host seconds per
    iteration between its events (``OrderRecorder.segments``; None for
    the inline path).
    """
    from repro_torch.core import krylov
    from repro_torch.core.krylov.distributed import distributed_solve
    from repro_torch.core.krylov.operator import BsrMatrix
    from repro_torch.core.krylov.operators import DiaMatrix
    from repro_torch.core.noise import NoiseHook
    from repro_torch.distributed import comm
    from repro_torch.distributed.overlap import (OrderRecorder,
                                                 depth_order_ok,
                                                 split_phase_ok)
    from repro_torch.kernels import ops

    dev = torch.device(device)
    outcomes = []
    for case in cases:
        A = case["A"]
        if isinstance(A, BsrMatrix):
            A = BsrMatrix(indices=A.indices.to(dev), blocks=A.blocks.to(dev))
        else:
            A = DiaMatrix(offsets=A.offsets, bands=A.bands.to(dev),
                          grid_shape=A.grid_shape)
        b = case["b"].to(dev)
        kw = dict(case.get("kw", {}))
        noise = case.get("noise")
        hook = None if noise is None else NoiseHook(*noise)
        sharded = kw.get("engine") == "sharded_fused"
        rec = OrderRecorder() if sharded else None
        solver = getattr(krylov, case["solver"])
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        comm.all_reduce.calls = 0
        comm.exchange.bytes.clear()
        t0 = time.perf_counter()
        grid = case.get("grid")
        res = distributed_solve(solver, A, b, None if grid is None
                                else (None, tuple(grid)), noise=hook,
                                recorder=rec, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        order_ok = None
        if rec is not None:
            steps = res.res_history.shape[-1]
            depth = int(kw.get("l", getattr(kw.get("options"), "depth", 1)))
            order_ok = (depth_order_ok(rec.events, -(-steps // depth))
                        if case["solver"] == "pipecg_l" and depth > 1
                        else split_phase_ok(rec.events, steps))
        outcomes.append(dict(
            x=_numpy(res.x), iters=_numpy(res.iters),
            res_norm=_numpy(res.res_norm),
            res_history=_numpy(res.res_history),
            detect_history=_numpy(res.detect_history),
            launches=launches, seconds=seconds,
            all_reduces=comm.all_reduce.calls,
            wire_bytes=dict(comm.exchange.bytes),
            reductions=(sum(e[0] == "issue" for e in rec.events)
                        if rec is not None else None),
            order_ok=order_ok,
            segments=rec.segments() if rec is not None else None,
            waits=(np.zeros(0) if hook is None else hook.shard_waits(rank))))
    return outcomes
