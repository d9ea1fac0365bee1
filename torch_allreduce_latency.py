#!/usr/bin/env python3
"""All-reduce latency of one float64 across the cards of one host.

    python3 torch_allreduce_latency.py [--ranks 4] [--backend nccl|gloo|shm]

Spawns one rank per card (``--ranks`` cards, NCCL by default; gloo stages
through the host), joins them through a FileStore in a temporary
directory, and times ``dist.all_reduce`` of a one-element float64 tensor
on the card:

* ``blocking_us``: host clock around one all-reduce followed by
  ``torch.cuda.synchronize()``, the cost a synchronizing dot pays on the
  critical path (median and 10th/90th percentiles of 2000 calls per
  rank, after 200 warm-up calls);
* ``stream_us``: CUDA events around 1000 back-to-back all-reduces on the
  stream, divided by 1000 (NCCL only).

``hop_us`` = median blocking time / (2 log2 P), the per-hop latency of
``core/noise/simulator.py::SolverPhaseModel.t_reduction``.

``--backend shm`` runs the ranks on one card, as the port's many-rank
solves do there (gloo, distributed/ranks.py), and times the port's
``comm.all_reduce`` of the same tensor twice: through the shared-memory
wire (``blocking_us``) and through gloo's sockets with the wire set
aside (``gloo_staged_us``), each with its host copies and the final
``torch.cuda.synchronize()``.  Prints the
card's ``nvidia-smi`` name and power limit and one JSON line, and writes
it to ``chiprun_out/allreduce_latency_<backend>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WARMUP = 200
REPS = 2000
STREAM_REPS = 1000


def _blocking(reduce, t, dev):
    """Host seconds of each of REPS blocking reductions (after WARMUP)."""
    for _ in range(WARMUP):
        reduce(t)
        torch.cuda.synchronize(dev)
    dist.barrier()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        reduce(t)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return times


def _rank(rank: int, world: int, backend: str, tmp: str) -> None:
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group("gloo" if backend == "shm" else backend,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world),
                            rank=rank, world_size=world, **kw)
    try:
        t = torch.ones(1, dtype=torch.float64, device=dev)
        extra = {}
        if backend == "shm":
            sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
            from repro_torch.distributed import comm, shm
            wire = shm.attach(os.path.join(tmp, "wire"), rank, world)
            times = _blocking(comm.all_reduce, t, dev)
            shm._WIRE = None            # the same helper on gloo alone
            staged = _blocking(comm.all_reduce, t, dev)
            shm._WIRE = wire
            shm.detach()
            extra["gloo_staged_us"] = statistics.median(staged) * 1e6
        else:
            times = _blocking(dist.all_reduce, t, dev)
        stream_us = None
        if backend == "nccl":
            dist.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(STREAM_REPS):
                dist.all_reduce(t)
            end.record()
            end.synchronize()
            stream_us = start.elapsed_time(end) * 1e3 / STREAM_REPS
        q = statistics.quantiles(times, n=10)
        out = dict(rank=rank, blocking_us=statistics.median(times) * 1e6,
                   blocking_p10_us=q[0] * 1e6, blocking_p90_us=q[-1] * 1e6,
                   stream_us=stream_us, **extra)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo", "shm"),
                    default="nccl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_allreduce_latency: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if args.backend == "nccl" and cards < args.ranks:
        print(f"torch_allreduce_latency: NCCL needs {args.ranks} cards, "
              f"found {cards}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="allreduce_") as tmp:
        if args.backend == "shm":
            sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
            from repro_torch.distributed import shm
            shm.create(os.path.join(tmp, "wire"), args.ranks)
        mp.spawn(_rank, args=(args.ranks, args.backend, tmp),
                 nprocs=args.ranks, join=True)
        per_rank = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                    for r in range(args.ranks)]
    blocking = max(r["blocking_us"] for r in per_rank)
    result = dict(
        card=torch.cuda.get_device_name(0),
        smi=smi.stdout.strip().splitlines(), cards=cards,
        ranks=args.ranks, backend=args.backend, dtype="float64", elems=1,
        blocking_us=blocking,
        **({"gloo_staged_us": max(r["gloo_staged_us"] for r in per_rank)}
           if args.backend == "shm" else {}),
        hop_us=blocking / (2.0 * math.log2(max(args.ranks, 2))),
        per_rank=per_rank)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"allreduce_latency_{args.backend}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
